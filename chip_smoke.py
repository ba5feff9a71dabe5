#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dccrg_tpu_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):

1. build      — compile every ``dccrg_tpu_torch/csrc/*.cu`` and the probes
                of phase 20 (a bare grid barrier, an empty kernel) with
                nvcc, in parallel, and
                print the command, seconds and ptxas report;
2. kernels    — each kernel against its plain PyTorch twin on the card, at
                the main path's shapes, bitwise (``torch.equal``; -0 == +0):
                the dense kernels on seeded fields (the whole-run kernel B1
                at 128x128x64 for 0, 1, 7, 50 and 300 steps, with open x and
                z faces, on an odd 33x17x9 block and on the largest block
                fused_run_fits admits at 128x128, 128x128x67; a plan made
                for another block refused before launch), the flat AMR
                kernels B5 and B6 on the refined grids of phases 6-7 (96^3
                and 64^3 voxels; 0, 1, 7, 8, 50 and 300 steps on a seeded
                random density, 7 and 8 on the initial one), B5 on an odd
                34x18x26 grid and on the largest flat_amr_fits admits
                (110x110x114, its weights read from L2) and, in phase 8, on
                the adapted grid; B6 on a four-level grid (kmax 2, cubes
                of edge 8) and on the largest flat_ml_kernel_fits admits at
                three levels (104x108x112); a plan made for another grid
                refused before launch by each), the Game of Life kernel B4
                on the 500x500 board
                (30% alive, open and periodic, 1, k-1, k, k+1, 7, 8 and 300
                turns, k its plan's turns a round), on boards of 1x500,
                500x1 and 5x7, and on a 500x500 board of values in {-1, 0,
                0.5, 1, 2, 3} (also bit for bit); a plan made for another
                board refused before launch), the Vlasov step kernel B7 at
                32^3 x 512 bins (one periodic slab; two slabs, open z, the
                edge planes read from the slab ring and given; open x and
                y), at 27 bins on two slabs (open y and z) and on the
                largest plane pick_vlasov_block admits at 512 bins (32 x
                66); the BiCG whole-solve kernel B8 on the flat tables of
                phases 12-13 (64^3 voxels, two-level and uniform; 60
                iterations), of a 9x7x5 grid with an open axis and all three
                cell roles, solved to a residual target it reaches early,
                and on the largest grids bicg_fits admits (100x98x98 with
                coarse rows, 98x98x100 without: the plan's l2 form); a plan
                made for another shape refused before launch by each of B7
                and B8; the halo's
                grouped gather B9 on the 8-slot refined grid of phase 17,
                in its three modes (payload, blocking, merge; one launch
                for all the fields of a state, the merge also against the
                blocking gather) for the three-field state (f64 scalar, f32
                (3,), uint32: 8- and 4-byte words), uint8 and f16 (3,)
                (1- and 2-byte words, also exchanged against the
                collective backend), and bool, bfloat16 (2,), int16 and f32
                (4,) (16-byte words); all eleven fields at once in
                ceil(11 / RING_MAX_FIELDS) launches; B9 on the particle
                state of phase 23 (int32 counts and rows of P x 3 f32) in
                its three modes; and
                the verify oracle (DCCRG_HALO_VERIFY=1) counting checks and
                no mismatch;
3. headline   — Grid 128x128x64 periodic -> Advection(float32) ->
                initialize_state -> max_time_step -> run(5000): must go
                through the whole-run kernel only; mass conserved; 200 steps
                checked against the twin and against the float64 step body;
                cell-updates/s (median of 3 timed runs);
4. large      — 512x512x128, run(200) + step: blocked step kernel only;
5. plane      — 128x128x63 (no z-block divides 63): step on one slab and
                run(50) on three slabs, plane step kernel only;
6. refined    — the bench's two-level grid (48^3, ball of radius 0.3 around
                (0.3, 0.5, 0.5) refined once, ~198k leaves) -> run(2000):
                one flat_amr_run launch; mass conserved; 200 steps against
                the twin and against the float64 gather step; leaf-updates/s;
7. refined3   — the bench's three-level grid (16^3, balls of radii 0.6 and
                0.55 refined in turn) -> run(1000): one flat_ml_run launch;
                the same checks;
8. adapt      — on the refined grid: run(50), check_for_adaptation,
                adapt_grid, run(50) (two flat_amr_run launches), then one
                step on the gather path (no kernel, no twin) and the gather
                step's rate over 20 steps; the adaptation's host seconds
                split into the epoch rebuild (incremental, or the full
                build it falls back to), remap_state and the rest, beside a
                full build_epoch of the adapted leaves;
9. gol        — the bench's Game of Life (500x500x1, neighborhood length 1,
                open, 30% alive from default_rng(0)) -> run(20000): one
                gol_run launch; 200 turns against the twin, 50 turns against
                the general gather path; cell-updates/s;
10. vlasov    — the bench's Vlasov (32^3 periodic, nv = 8, float32, dt =
                0.4 x max_time_step) -> run(50): 50 vlasov_step launches;
                mass conserved; 5 steps against the twin (bitwise) and the
                float64 plain step; phase-space cell-updates/s;
11. vlasov_amr — Vlasov (nv = 4, float32) on a refined 16^3 grid: the
                general gather path (no kernel, no twin), mass conserved;
                seconds a step;
12. poisson   — the bench's Poisson (32^3 periodic, ball r<0.25 around the
                centre refined once: 48,000 leaves, 64^3 voxels; float32,
                sin(2 pi x) cos(2 pi y) minus its mean) -> one warm-up solve
                of 2 iterations, then solve(60 iterations, residual target
                0, no semi-convergence stop): one bicg_solve launch, 60
                iterations; a solve to residual 8.0, and a 60-iteration
                solve of a seeded random rhs, against the float32 flat solve
                without the kernel; cell-iterations/s (median of 3);
13. poisson_uniform — 64^3 uniform periodic, float32, the same solve
                through bicg_solve without coarse rows; the rhs is an
                eigenvector, so the 60-iteration solution is held against
                the plain flat solve's and the residual must fall 1e4-fold;
                the same random-rhs check;
14. poisson3  — the bench's three-level Poisson (16^3, balls r<0.35 then
                r<0.25: 24,368 leaves on levels 0-2, 64^3 voxels): the
                multi-level flat operator in torch, no kernel; the flat
                operator and its transpose against the gather operator in
                float64 (1e-13); cell-iterations/s;
15. poisson_rolled — the poisson grid without the flat operator: the rolled
                static-offset operator, no kernel; against the gather
                operator in float64 (1e-12 of the peak); cell-iterations/s;
16. halo      — the 8-slot refined grid's exchange of a three-field state,
                blocking and start/wait on the Grid: one ring_copy launch
                for the blocking exchange, one for start and one for finish
                (also counted, after phase 17's rates, in a profiler trace:
                no other kernel), bitwise
                equal to each other and to the collective backend; ring
                distances, S_k, bytes, and each
                form's exchange time (device, queued; wall, synchronised;
                allocator segments added while queued); a one-slot grid's start
                launches nothing and returns an empty handle;
17. split_advection — the refined grid of phase 6 on 8 slots (198,008
                leaves): Advection(float32, overlap=True).run(200), two
                ring_copy launches a step (start, finish); bitwise equal to
                the eager gather
                step after each of the first 20 steps and after 200; mass
                conserved; leaf-updates/s of both forms; a profiler trace
                of 5 split steps says whether the side-stream copy ran
                beside other kernels, B9's launches and mean device time a
                launch on each stream (payloads on the side stream, merges
                on the model's), and the device's busy share;
18. split_vlasov — Vlasov (nv = 8, 512 bins, float32) on the refined 16^3
                grid (7,456 leaves) on 8 slots: the ring copy of f (2 KiB
                rows, 16-byte words) against its twin, and one eager
                exchange of the state against the collective backend,
                bitwise; 20 split steps, bitwise equal to the eager general
                step after each; phase-space cell-updates/s of both forms;
                the same profiler trace;
19. split_gol — the bench's Game of Life on 8 slots, GameOfLife(overlap=
                True).run(200) (two ring_copy launches a turn): its alive set
                equal to the one-slot gol_run run's; cell-updates/s;
20. timing    — each kernel beside its twin and its least possible time, the
                ring copy also beside torch.index_select, on copies of the
                field that exceed the L2 (its L2-resident time logged too),
                B9's merge at split_advection's and split_gol's fields and
                the grouped blocking exchange of the three-field state (one
                launch) beside their bounds, and an empty kernel on the
                ring copy's grid (the launch floor);
                the launch plans of B1, B4, B5, B6, B7 and B8 (bricks or
                tiles, their extents, shared memory a CTA, CTAs, turns a
                round, what lives in shared memory, registers and L2) with
                the registers ptxas gave each, and the bare grid barrier
                timed on each whole-run kernel's grid (B8's: 120, two an
                iteration) and on the 4,096-CTA grid of the streaming B6
                they replaced;
21. balance   — phase 17's grid (198,008 leaves, 8 slots): Advection
                (float32, gather step) 20 steps, the refined cells weighted
                2, balance_load under HSFC, remap_state, a ghost refresh, 20
                steps (41 ring_copy launches): bitwise equal by cell id to
                40 steps without the balance, mass conserved; again with the
                staged form (chunks of 20,000 cells), bitwise equal to the
                one-shot form; the 500x500 board's uint32 state staged in
                chunks of 50,000 cells on 8 slots, every cell's value kept,
                equal to the one-shot form; the host seconds of balance_load under HSFC,
                RCB and GRAPH with the incremental rebuild and with
                DCCRG_EPOCH_DELTA=0, cells moved, weighted imbalance before
                and after;
22. pic       — the bench's PIC (1,000,000 particles from default_rng(0) on a
                periodic 32^3 grid, one slot, capacity twice the largest
                occupancy, the rotating velocity field, dt = 0.2/32,
                float32) -> run(50): the device re-bucket, every particle
                kept, none dropped; 5 steps bitwise equal to the host
                re-bucket; pushes/s including migration (median of 3);
23. pic_refined_lb — 200,000 particles on 16^3 with the ball r < 0.25 refined
                once and an HSFC balance, on 8 slots, dt = 0.1/16 -> run(50):
                two ring_copy launches a step (counts, then coordinates);
                the same checks, each cell's particles equal to the
                unbalanced 8-slot run's; pushes/s; B9 timed at the particle
                state's two row widths;
24. boxed     — (run after phase 7, on its grids) the boxed per-level
                passes of the refined and refined3 grids, 200 steps against
                the flat kernel (B5 / B6) within 1e-4 of the peak density,
                mass conserved; leaf-updates/s of each; the edge the card
                gives (flat voxel-updates/s over boxed) beside the dispatch
                constant, and which path the dispatch takes;
25. checkpoint — (run after phase 8) the adapted refined state (six f32
                fields) saved from the card, quick_validate, reloaded on 1
                and 8 slots, whole and in chunks of 20,000 cells: rows
                bitwise equal by cell id; 20 steps after the reload (B5 on
                one slot, the gather step on 8 after a ghost refresh)
                bitwise equal to 20 without; bytes written, host seconds to
                save, validate and load;
26. vtk       — (after 25) write_vtk_file of the adapted grid with its
                density: bytes and host seconds;
27. xla_flat  — (after phase 17) the sharded form on phase 17's 8-slot
                grid, 200 steps against the eager gather step within 1e-4,
                and the float64 ml form on refined3 against the float64
                gather step within 1e-11; leaf-updates/s of each;
28. c1        — the refined and refined3 grids at neighbourhood length 1:
                200 gather steps with relative mass drift below 1e-5 (the
                drift of the classification before the repair logged
                beside it), run(200) through B5 / B6 against the 200
                gather steps within 1e-4;
29. obs       — (after phase 17) the observability plane (``obs``):
                split_advection's 50 steps and the adapted refined grid's
                run(200) with telemetry on and ``disable()``d in turns (off,
                on, on, off; five rounds): the median on/off ratio of each,
                at most 1.10; ``profile_trace`` around 5 split steps and a
                headline run(50), ``merge_profile``: the merged trace valid,
                at least 2 clock syncs, device time attributed to
                ``halo.ring_copy`` and ``fused_run``, the merged
                ``device.busy_fraction{device=0}`` within 0.02 of the union
                of the raw trace's kernel, copy and memset intervals over
                their first start to last end, ``overlap.fraction{phase=
                halo}`` in [0, 1], the top 5 host gaps with their open host
                phases, the Kineto categories seen; ``sample_hbm`` after a
                refined epoch build equal to the allocator's
                ``memory_allocated`` / ``max_memory_allocated``; a small
                8-slot workload (exchange, HSFC balance_load, refine,
                save_grid_data) fires ``halo.exchange``, ``epoch.build``,
                ``loadbalance.migrate``, ``amr.refine`` and
                ``checkpoint.write`` with nonzero byte counters, and its
                ``telemetry.json``, stream, timeline trace and flight
                recorder dump pass the port's own readers and validators.

30. resilience — (at the end) the resilience layer on the card, in f32 at
                the bench's widths: the headline (128x128x64) run(300) on one
                slot (B1) as the reference; a child process runs it in
                segments of 50 steps with a lineage commit after each (keep
                3) and ``sigkill.post_commit`` armed, and must die by SIGKILL
                after its second commit, leaving a valid flight-recorder dump
                naming the segment in flight and a report of 0
                ``epoch.recompiles`` (the libraries of phase 1 on disk);
                the lineage's ``latest_valid`` on 8 slots (``BLOCK``, the
                z-slabs of the per-step dense kernel), then ``verify_grid``,
                must find generation 2 at step 100,
                100 steps there, ``rescale`` to 1 slot, 100 steps through B1:
                the density bitwise equal to the reference; a commit with
                ``checkpoint.torn_write`` armed raises
                ``CheckpointError("lineage")`` and ``latest_valid`` returns
                the previous generation; the bench's 500x500 board, 300
                turns rescaled 1 -> 8 -> 1 after turns 100 and 200, equal to
                one-slot B4's alive set; a supervised child on 8 slots
                (commits every 25 turns, heartbeat stream, ``step.hang``
                after turn 60) must be seen stalled (no-progress) and climb
                warn -> rescale_down, then relaunched on 4 slots from
                ``latest_valid`` it must finish with the same alive set; a
                ``halo.nan`` storm through one blocking exchange of phase
                17's grid leaves ``verify_finite`` raising, the next exchange
                clean and the input unchanged.  Commit and re-landing seconds
                of each rescale, the lineage's bytes and the phase's seconds
                are logged with the card.

31. serve     — (before 30) the serving tier (``dccrg_tpu_torch.serve``) on
                the card at the bench's widths: dense advection cohorts of
                the headline member (128x128x64, one slot, W = 1, 4, 16,
                per-member dt = max_time_step x (0.3 + 0.02 w), k =
                16, 64 steps: B2 with its member axis, one launch a step),
                the plane kernel's cohort (B3, 128x128x63 on 3 slots, W = 4,
                10 steps), the Vlasov member (32^3 x 512 bins, B7, W = 4,
                k = 10, 20 steps) and the split advection cohort on phase
                17's grid (B9 on member-offset ring tables, W = 4, k = 4, 20
                steps: two launches a step for all members), each member
                bitwise equal to its own solo steps; the member-axis
                launches timed beside W x one member's bound; the bench's
                ensemble sweep (Game of Life on 4^3, cohorts of 1, 64 and
                256, k = 1, 4, 16: scenario-steps/s, amortization over solo,
                bytes a member shared and stacked, the verify oracle at each
                k with no mismatch) and wide-halo sweep (6^3 on 2 slots at
                neighbourhood length 2 and 4, 16 members, k = 4 and 16,
                against the exchange-every-step body: exchanges a step,
                rates, owned rows bitwise equal); the fleet gateway (two
                workers of one slot, 24 seeded Game of Life and advection
                scenarios, a worker and then the gateway SIGKILLed and the
                gateway relaunched over its journal: every scenario retired
                exactly once, equal to the solo oracle, a postmortem naming
                the lost worker, no kernel built in any worker), then the
                fleet's admission A/B (A16, ``soak.fleet_admission_ab``: one
                worker with admission on, then off; on, the burst rejected
                and the deadline tenant on time; off, nothing rejected and a
                deadline miss; the chunk, its rate and both modes logged).

32. spmd     — (at the end) several controllers (``parallel/mesh.py``):
                2 processes of 4 slots each on the card over gloo
                (``--child spmd``, started by ``mesh.launch``) run the
                bench's 500x500 board for 200 gather turns and the refined
                grid (198,008 leaves, f32) for 20 gather steps, an
                ``adapt_grid`` with different refine requests on each
                controller, an HSFC ``balance_load`` with per-controller
                pins and ``remap_state``, 20 more steps, a checkpoint saved
                (rank 0 writes) and reloaded, and 20 timed blocking density
                exchanges, while this process runs the same on one
                controller of 8 slots: every controller's alive set,
                density, owners and checkpoint bytes bitwise equal to it;
                B9 launched on each controller in each part (two launches
                an exchange around the transport), no twin; each
                controller's exchange wall ms, transport bytes and B9
                launches logged; then 3 controllers x 2 slots on small
                sizes, and nccl with a card a controller where the machine
                has two (else one line says why not).  Inside the same
                controller processes, the dense slab ring (D1, D3) at the
                bench's widths, each case against the oracle on its own slot
                count (SPMD_DENSE_LAYOUT): the headline 128x128x64 on 2 x 4
                through B2 (B = 8, run(50): 50 launches a controller, the
                density planes a step and the vz planes once a run over the
                transport), the 128x128x63 plane grid on 3 x 1 through B3
                (step + run(20): 21 launches), the 500x500 board on 2 x 2
                through the torch dense loop (200 turns, no kernel), Vlasov
                32^3 x 8^3 on 2 x 4 through B7's explicit-edge mode (run(20):
                20 launches) and Vlasov's gather step on the refined 16^3
                grid (nv = 4, run(5): B9 two launches a step); every slot's
                result bitwise equal to the oracle's, the ring's bytes two
                planes an exchange, the launches, bytes a step and wall ms a
                step logged beside the oracle's.  And the models (D2, D4,
                D5) in the same processes, each against the oracle on the
                same slots (SPMD_MODELS): the bench's Poisson grid (refined
                32^3, 48,000 leaves, 64^3 voxels, f32, 60 iterations with no
                early stop) through the flat voxel operator across
                controllers (``BLOCK``: the ring's planes each matvec) and
                through the rolled operator (``HSFC``: B9 pack + merge each
                ghost refresh); 200,000 particles on the refined, balanced
                16^3 grid (run(20), two exchanges a step, B9 on each);
                the refined 48^3 grid's ``sharded`` form (run(50)) and
                boxed passes (20 steps) and refined3's ``ml`` form (f64,
                run(50)), all ``BLOCK``, riding the ring with no kernel;
                the solution and iterations, the count, positions and lost
                count, the density bitwise equal to the oracle's, the
                operator space or flat kind, B9's launches a controller and
                no twin checked; wall ms a step or iteration and ring or
                transport bytes logged beside the oracle's.  ``python3
                chip_smoke.py --spmd-only`` runs this phase, 33 and 34.

33. spmd serve and lineage — (after 32) the split steps (D6), cohorts
                (D7) and the lineage (D9) across controllers on the card
                over gloo (``--child spmd33``, three launches), each against
                this process's one controller on the same slots (sizes in
                ``SPMD33``, layouts in ``SPMD33_COHORTS``): on 2 x 4 the
                split step of the refined 48^3 grid (198,008 leaves, f32,
                20 steps), Vlasov on the refined 16^3 grid (7,456 leaves x
                512 bins, 10 steps) and the 500x500 board (50 turns), each
                beside as many blocking gather steps (B9 two launches a step
                a controller, wall ms a step logged); cohorts with
                ``Cohort.step(k)``: the headline 128x128x64 (W = 4, k = 16,
                32 steps, B2 one launch a step for all members), Vlasov 32^3
                x 8^3 (W = 4, 10 steps, B7's explicit-edge member mode), the
                split-phase refined grid (W = 4, k = 4, 10 steps, B9 on
                member tables), the wide step (6^3 at neighbourhood length
                2 on 2 x 1, W = 16, k = 4), the plane grid 128x128x63 on 3 x
                1 (W = 4, 10 steps, B3), and a deadline ``Ensemble`` of 8
                seeded headline scenarios; every member bitwise equal to the
                oracle's and to its solo run.  Then the headline's lineage:
                run(300) with a commit every 100 steps, controller 1 killed
                by ``sigkill.post_commit`` after its second commit,
                relaunched from ``latest_valid`` on 2 x 4, rescaled to 2 x 2
                at step 250 and finished: bitwise equal to one controller's
                uninterrupted run(300) on 8 slots; commit and rescale
                seconds logged.

34. ipc      — (after 33) the device-direct transport (D8,
                ``DCCRG_TORCH_DIST_BACKEND=ipc``): phase 32's 2 x 4 run
                (gather, dense, models) and phase 33's split cases and the
                dense, Vlasov and split cohorts, on 2 controllers of the card
                over gloo and then over ipc, each launch alone, every result
                bitwise equal to the oracles of 32 and 33, B9 on every
                controller with no twin, 0 pinned host bytes staged under
                ipc; each case's wall ms and transport bytes under both
                transports, the host round trips (gloo, ipc's token sockets)
                and B9's remote write (``ring_put``) at the split packs,
                against its twin, its own arena and its bound, logged.

Launch counters are set to 0 just before each of phases 3-19, 21-28,
each sub-step of 30 and 31, and (in each controller) each part of 32, 33
and 34 drives its path and read just after.  Telemetry is on throughout, as it
is by default.  Output ends with the card's name and power limit, one
JSON line of per-kernel numbers, and the result line
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""
from __future__ import annotations

import copy
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

#: H100 SXM peaks (NVIDIA data sheet): device memory bytes/s, f32 flop/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: f32 operations a cell update needs: the whole-run kernel, with the face
#: weights hoisted, 4 face products + 5 sums + the final multiply-add; a
#: one-step kernel adds 4 faces x (sum, half, dt, area, mask) = 20
RUN_FLOPS_PER_CELL = 11
STEP_FLOPS_PER_CELL = 31
#: f32 operations a voxel a step of the flat two-level kernel in the JAX
#: body's form (ops/flat_amr.py:345-376): 3 fluxes x 3, 5 delta sums, the
#: pool mask, 3 pool sums, the origin mask, 3 broadcast sums, 4 for the
#: update
FLAT_AMR_FLOPS_PER_VOXEL = 26
#: operations a cell a turn that the Game of Life needs: 7 adds over the 8
#: neighbours, the rule's 2 compares and 1 select (new = c == 2 ? a :
#: c == 3); the open edges' masks do nothing on interior cells
GOL_OPS_PER_CELL = 10
#: f32 operations a phase-space cell a step of the Vlasov split step: three
#: splits of 2 flux products, a difference, the scaled product and the
#: subtraction (the edge planes' two xy splits counted apart)
VLASOV_FLOPS_PER_CELL = 15
#: f32 operations a voxel a BiCG iteration that the masked solve needs: the
#: matvec and its transpose 13 each (6 products, 5 sums, the diagonal's
#: product and sum), their solve masks 2, three dots 3 each (product, mask,
#: sum), the x / r0 / r1 / p0 / p1 updates 2 each, the best-x copy 1;
#: coarse rows add 4 to each matvec (the coarse-mask product 1, the block's
#: pool 7/8 and origin product 1/8, the fine product 1, the final sum 1)
BICG_FLOPS_PER_VOXEL = 48
BICG_COARSE_FLOPS_PER_VOXEL = 8
#: the bench's PIC configuration (bench.py: BASELINE.md config 4): 1M
#: particles on a uniform 32^3 grid, and the refined, HSFC-balanced variant
#: of 200k on 16^3
PIC_N, PIC_GRID = 1_000_000, 32
PIC_REFINED_N, PIC_REFINED_GRID = 200_000, 16


def flat_ml_flops_per_voxel(cap_active) -> int:
    """f32 operations a voxel a step of the multi-level kernel in the JAX
    body's form (ops/flat_amr.py:1054-1084): 14 for delta, 2 masks, per
    doubling k 3 pool sums and, where it captures, a mask, 3(k+1) broadcast
    sums and an accumulate, then the final sum."""
    kmax = max((k for k, a in enumerate(cap_active) if a), default=-1)
    n = 14 + 2 + 1
    for k in range(kmax + 1):
        n += 3 + (2 + 3 * (k + 1) if cap_active[k] else 0)
    return n


#: phase 20's scratch kernels, built beside the package's kernels and not
#: among them: ``steps`` bare grid barriers on a cooperative grid of
#: ``ctas`` CTAs of bx x by threads (what B1, B5 and B6 pay to synchronise a
#: step, B4 a round), and an empty kernel (the launch floor beside B9)
BARRIER_PROBE = r"""
#include <cooperative_groups.h>
__global__ void barrier_loop(int steps) {
  for (int i = 0; i < steps; ++i) cooperative_groups::this_grid().sync();
}
extern "C" int barrier_probe(int ctas, int bx, int by, int steps, void* stream) {
  void* args[] = {&steps};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)barrier_loop, dim3(ctas),
                                                dim3(bx, by), args, 0,
                                                (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
__global__ void empty_kernel() {}
extern "C" int empty_launch(int ctas, int threads, void* stream) {
  empty_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
#: cudaErrorInvalidValue: what a whole-run launcher returns for a plan that
#: does not fit its block or board
CUDA_INVALID_VALUE = 1


def ptxas_registers(ptxas: str, kernel: str) -> str:
    """The ptxas lines of registers and of stack and spills of the entry
    whose mangled name holds ``kernel``, from ``-Xptxas -v`` output."""
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found = [nxt.split(":", 1)[-1].strip() for nxt in lines[i + 1:i + 4]
                     if "registers" in nxt or "spill" in nxt]
            if found:
                return "; ".join(found)
    return "not in this run's build log"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------ 30. resilience
#: the headline's lineage carries the four fields a step reads
HEADLINE_FIELDS = ("density", "vx", "vy", "vz")
#: phase 30's sizes: the bench's headline (bench.py:39-40) and Game of Life
#: board (bench.py:48,55), the steps (and turns) of each run, the crash
#: child's segment of steps (a commit after each), the supervised child's
#: turns between commits and the supervisor's stall window in seconds
RES_HEADLINE = (128, 128, 64)
RES_BOARD = 500
RES_STEPS = 300
RES_SEG_STEPS = 50
RES_GOL_COMMIT_EVERY = 25
RES_STALL_AFTER_S = 3.0


def headline_model(shape, device):
    """bench.py's headline (an nx x ny x nz periodic grid, f32, the model's
    initial state, dt at 0.4 of the CFL limit) on one slot of ``device``,
    partitioned ``BLOCK``: a re-landing on D slots under the same method
    keeps the id-order z-slabs a dense model needs.  The crash child and
    this process build it alike."""
    import numpy as np

    from dccrg_tpu_torch import Advection, CartesianGeometry, Grid

    nx, ny, nz = shape
    g = (Grid().set_initial_length((nx, ny, nz)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_load_balancing_method("BLOCK")
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / nx, 1.0 / ny, 1.0 / nz))
         .initialize(n_devices=1, device=device))
    adv = Advection(g, dtype=np.float32)
    state = adv.initialize_state()
    return g, adv, state, 0.4 * adv.max_time_step(state)


def headline_spec():
    import numpy as np

    return {k: ((), np.float32) for k in HEADLINE_FIELDS}


def land_headline(g, rows):
    """The dense model of a (re-)landed headline grid, its state set by
    cell id from the loaded rows."""
    import numpy as np

    from dccrg_tpu_torch import Advection

    adv = Advection(g, dtype=np.float32)
    s = adv.initialize_state()
    ids = g.get_cells()
    for f in HEADLINE_FIELDS:
        s = adv.set_cell_data(s, f, ids, g.get_cell_data(rows, f, ids))
    return adv, s


def gol_board(n, n_devices, device):
    """bench.py's Game of Life board (n x n, open, 30% alive from
    default_rng(0)) on ``n_devices`` slots; returns (grid, alive cells)."""
    import numpy as np

    from dccrg_tpu_torch import Grid

    g = (Grid().set_initial_length((n, n, 1)).set_neighborhood_length(1)
         .initialize(n_devices=n_devices, device=device))
    cells = g.get_cells()
    return g, cells[np.random.default_rng(0).random(len(cells)) < 0.3]


def _write_json(path, rec):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _child_report(extra):
    from dccrg_tpu_torch import cuda_build, obs
    from dccrg_tpu_torch.ops import LAUNCHES

    rep = obs.metrics.report()
    return {**extra,
            "recompiles": int(sum(rep["counters"].get("epoch.recompiles", {}).values())),
            "launches": {k: v for k, v in LAUNCHES.items() if v},
            "libraries": sorted(cuda_build._libs)}


def child_headline(wd, device):
    """The crash child: the headline in segments of ``RES_SEG_STEPS`` steps
    on one slot, a lineage commit after each (keep 3).  Armed from the
    environment (``DCCRG_FAULT``), it dies by SIGKILL after a commit; its
    report (``report.json``, written before each commit) holds what it
    compiled and launched, and its flight recorder names the segment in
    flight."""
    from dccrg_tpu_torch.obs import flightrec
    from dccrg_tpu_torch.resilience import CheckpointLineage

    flightrec.recorder.arm(wd, period=0.5)
    g, adv, state, dt = headline_model(RES_HEADLINE, device)
    lineage = CheckpointLineage(os.path.join(wd, "lineage"), keep=3)
    step = 0
    while step < RES_STEPS:
        flightrec.recorder.mark_unit(f"headline/{step}", tenant="smoke",
                                     phase="headline", step=step)
        flightrec.recorder.checkpoint(force=True)
        state = adv.run(state, RES_SEG_STEPS, dt)
        step += RES_SEG_STEPS
        rows = adv._dense_to_rows(state)
        _write_json(os.path.join(wd, "report.json"), _child_report({"step": step}))
        lineage.commit(g, rows, headline_spec(), user_header=str(step).encode())
    print("HEADLINE_CHILD_DONE", flush=True)


def child_gol(wd, device, n_devices, hb):
    """The supervised child: the board on ``n_devices`` slots, resumed from
    its lineage when one survives, a commit every ``RES_GOL_COMMIT_EVERY``
    turns up to ``RES_STEPS``, a 0.5 s
    heartbeat stream (``hb``) plus a beat with the turn before each turn,
    and the ``step.hang`` seam armed from the environment.  Writes the
    final alive set and its report."""
    import numpy as np

    from dccrg_tpu_torch import GameOfLife, obs
    from dccrg_tpu_torch.io.checkpoint import CheckpointError
    from dccrg_tpu_torch.obs import flightrec
    from dccrg_tpu_torch.resilience import CheckpointLineage, inject

    stream = obs.stream_to(hb, period=0.5, extra={"subsystem": "smoke"})
    flightrec.recorder.arm(wd, period=0.5)
    g, alive0 = gol_board(RES_BOARD, n_devices, device)
    lineage = CheckpointLineage(os.path.join(wd, "gol"), keep=3)
    try:
        g, s, hdr, gen = lineage.latest_valid(GameOfLife.SPEC, n_devices=n_devices,
                                              device=device)
        step = int(hdr)
        print(f"RESUMED gen={gen} step={step} n_devices={n_devices}", flush=True)
    except CheckpointError:
        s = None
        step = 0
        print(f"FRESH n_devices={n_devices}", flush=True)
    gol = GameOfLife(g)
    if s is None:
        s = gol.new_state(alive_cells=alive0)
    resumed_at = step
    while step < RES_STEPS:
        flightrec.recorder.mark_unit(f"gol/{step}", tenant="smoke", phase="gol", step=step)
        flightrec.recorder.checkpoint(force=True)
        stream.write_snapshot(phase="gol", step=step)
        inject.maybe_hang("step.hang", seconds=600.0)
        s = gol.run(s, 1)
        step += 1
        if step % RES_GOL_COMMIT_EVERY == 0:
            lineage.commit(g, s, GameOfLife.SPEC, user_header=str(step).encode())
    np.save(os.path.join(wd, "alive.npy"), np.sort(gol.alive_cells(s)))
    _write_json(os.path.join(wd, "report.json"),
                _child_report({"resumed_at": resumed_at, "n_devices": n_devices}))
    print("GOL_CHILD_DONE", flush=True)


#: phase 32's sizes: the bench's Game of Life (bench.py:48,55: the 500x500
#: open board at 30% alive, 200 turns) and refined advection grid
#: (bench.py:41-42: 48^3, the ball of radius 0.3 around (0.3, 0.5, 0.5)
#: refined once, 198,008 leaves, f32; 20 gather steps either side of the
#: adaptation and balance) on SPMD_SLOTS slots over SPMD_CONTROLLERS
#: controllers; "small" is the odd-count check (3 controllers x 2 slots)
SPMD_CONTROLLERS, SPMD_SLOTS = 2, 8
SPMD_SIZES = {
    "full": {"board": RES_BOARD, "n": 48, "turns": 200, "steps": 20, "reps": 20},
    "small": {"board": 60, "n": 12, "turns": 20, "steps": 5, "reps": 5},
}
#: the phase's budget, process start-ups included (logged beside its time)
SPMD_BUDGET_S = 90.0
#: phase 32's dense cases (D1, D3): (controllers, slots a controller) of
#: each; a case runs in the launch of its controller count, and the oracle
#: runs it on one controller with the same slots.  "plane" takes 3 x 1
#: (63 z planes divide over 3 slots, not over 2 or 6) and the board 2 x 2
#: (500 rows do not divide over 8 slots)
SPMD_DENSE_LAYOUT = {"headline": (2, 4), "plane": (3, 1), "board": (2, 2),
                     "vlasov": (2, 4), "vlasov_amr": (2, 4)}
#: their widths: the bench's (headline 128x128x64 periodic f32, bench.py:
#: 39-40; the plane kernel's 128x128x63; the 500x500 open board at 30%
#: alive, bench.py:48,55; Vlasov 32^3 x 8^3 f32, bench.py:49,54; vlasov_amr
#: the refined 16^3 grid of phase 11 at nv = 4), and "small" for the CPU
#: rehearsal; the steps are cut (the bench runs 5000 / 20000 / 50) and
#: the same at both sizes
SPMD_DENSE = {
    "full": {"headline": (128, 128, 64), "plane": (128, 128, 63), "board": RES_BOARD,
             "vlasov": ((32, 32, 32), 8), "vlasov_amr": (16, 4)},
    "small": {"headline": (16, 16, 16), "plane": (16, 16, 15), "board": 60,
              "vlasov": ((8, 8, 16), 2), "vlasov_amr": (8, 2)},
}
SPMD_DENSE_STEPS = {"headline": 50, "plane": 20, "board": 200, "vlasov": 20,
                    "vlasov_amr": 5}
#: phase 32's models (D2, D4, D5), in the SPMD_CONTROLLERS launch at the
#: bench's widths ("full") and in the 3 x 2 launch at "small" ones (by the
#: slot count D: edges 2D, so the voxel z-slabs hold whole coarse blocks):
#: the Poisson grid (bench.py:461-530: 32^3, the ball r < 0.25 refined
#: once, f32, the bench's rhs; ``BLOCK`` for the flat operator's voxel
#: z-slabs), the refined PIC grid (bench.py:52-53,431-450: 200,000
#: particles of seed 1 on 16^3, the ball r < 0.25 refined once, HSFC
#: balanced), the refined grid (bench.py:41-42: 48^3, the ball r < 0.3
#: around (0.3, 0.5, 0.5), f32) for the ``sharded`` form and the boxed
#: passes, refined3 (bench.py:43-45: 16^3, balls r < 0.6 and r < 0.55,
#: f64) for ``ml``, all three ``BLOCK``.  Steps are cut: 60 iterations as
#: the bench, run(20) particle steps (the bench: 50), run(50) flat steps
#: (phase 27: 200), 20 boxed steps (phase 24: 200)
SPMD_MODELS = {
    "full": lambda D: {"poisson": 32, "pic": (200_000, 16), "refined": 48,
                       "refined3": (16, (0.6, 0.55))},
    "small": lambda D: {"poisson": 2 * D, "pic": (20_000, 2 * D), "refined": 2 * D,
                        "refined3": (2 * D, (0.35, 0.25))},
}
#: the rolled Poisson operator's partition by slot count: its offset
#: decomposition refuses the slabs that cut the ball on 8 BLOCK slots (17.7%
#: exceptions on two of them, over its 15%), not HSFC's; on 6 slots of the
#: small grid BLOCK's and not HSFC's
SPMD_ROLLED_LB = {8: "HSFC", 6: "BLOCK"}
SPMD_MODEL_STEPS = {"poisson": 60, "poisson_rolled": 60, "pic_refined_lb": 20,
                    "sharded": 50, "ml": 50, "boxed": 20}


def spmd_run(ctl, nproc, D, wd, device, size, dense=None) -> dict:
    """Phase 32's scenario on the controllers ``ctl`` (``mesh.SINGLE``: the
    one-controller oracle, which applies every rank's requests itself, in
    rank order) with D slots on ``device``: the board's gather turns; the
    refined grid's gather steps, an adaptation with different refine
    requests on each controller, an HSFC balance with per-controller pins
    and ``remap_state``, as many steps again, a checkpoint saved (rank 0
    writes) and reloaded; then the blocking density exchange timed.
    Returns hashes of the alive set, the density by cell id, the owners and
    the checkpoint's bytes, and this controller's B9 launches, transport
    bytes and seconds; with ``dense`` (a key of SPMD_DENSE) also the dense
    cases of ``nproc`` controllers (:func:`spmd_dense`)."""
    import hashlib

    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, CartesianGeometry, GameOfLife, Grid
    from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
    from dccrg_tpu_torch.utils.collectives import barrier

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    def sync():
        barrier("spmd")
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def counted(fn):
        """``fn()`` with the counts at 0: (its value, B9 launches, other
        launches, twin calls, seconds)."""
        sync()
        reset_counts()
        t = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t
        others = {k: v for k, v in LAUNCHES.items() if v and k != "ring_copy"}
        return out, LAUNCHES["ring_copy"], others, sum(PLAIN_CALLS.values()), secs

    ranks = [ctl.rank] if ctl.multi else list(range(nproc))
    res = {"rank": ctl.rank, "backend": ctl.backend or "none", "n_devices": D}
    t0 = time.perf_counter()

    n = size["board"]
    g = (Grid().set_initial_length((n, n, 1)).set_neighborhood_length(1)
         .initialize(n_devices=D, device=device, controllers=ctl))
    cells = g.get_cells()
    gol = GameOfLife(g, allow_dense=False)
    s = gol.new_state(alive_cells=cells[np.random.default_rng(0).random(len(cells)) < 0.3])
    b0 = g.halo().transport_bytes
    s, b9, others, plain, secs = counted(lambda: gol.run(s, size["turns"]))
    alive = np.sort(gol.alive_cells(s))
    res["gol"] = {"alive_hash": h(alive), "n_alive": int(len(alive)), "b9": b9,
                  "others": others, "plain": plain, "s": secs,
                  "transport_bytes": g.halo().transport_bytes - b0}
    del g, gol, s

    m = size["n"]
    ga = (Grid().set_initial_length((m, m, m)).set_neighborhood_length(0)
          .set_periodic(True, True, True).set_maximum_refinement_level(1)
          .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1.0 / m,) * 3)
          .initialize(n_devices=D, device=device, controllers=ctl))
    centre = np.asarray((0.3, 0.5, 0.5))
    ids = ga.get_cells()
    ga.refine_completely_many(ids[np.linalg.norm(ga.geometry.get_center(ids) - centre,
                                                 axis=1) < 0.3])
    ga.stop_refining()
    res["n_leaves"] = int(len(ga.get_cells()))
    adv = Advection(ga, dtype=np.float32, allow_dense=False, use_kernels=False)
    sa = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(sa)

    def steps(adv, sa):
        for _ in range(size["steps"]):
            sa = adv.step(sa, dt)
        return sa

    sa, b9_a, others_a, plain_a, secs_a = counted(lambda: steps(adv, sa))
    # different refine requests on each controller: rank p asks for every
    # nproc-th level-0 cell of the shell just outside the ball
    ids = ga.get_cells()
    lv = ga.mapping.get_refinement_level(ids)
    rr = np.linalg.norm(ga.geometry.get_center(ids) - centre, axis=1)
    shell = ids[(lv == 0) & (rr >= 0.3) & (rr < 0.3 + 3.0 / m)]
    for p in ranks:
        ga.refine_completely_many(shell[p::nproc])
    t = time.perf_counter()
    adv, sa, new_cells, _ = adv.adapt_grid(sa)
    adapt_s = time.perf_counter() - t
    ga.set_partitioning_option("LB_METHOD", "HSFC")
    cells = ga.get_cells()
    for p in ranks:
        ga.pin(int(cells[p * (len(cells) // nproc)]), D - 1 - p)
    t = time.perf_counter()
    ga.balance_load()
    sa = ga.update_copies_of_remote_neighbors(ga.remap_state(sa))
    balance_s = time.perf_counter() - t
    adv = Advection(ga, dtype=np.float32, allow_dense=False, use_kernels=False)
    sa, b9_b, _, plain_b, secs_b = counted(lambda: steps(adv, sa))
    cells = ga.get_cells()
    rho = ga.get_cell_data(sa, "density", cells)
    res["advection"] = {
        "n_leaves": int(len(cells)), "new_cells": int(len(new_cells)),
        "rho_hash": h(rho), "owners_hash": h(ga.leaves.owner.astype(np.int64)),
        "b9": b9_a + b9_b, "others": others_a, "plain": plain_a + plain_b,
        "steps_s": secs_a + secs_b, "adapt_s": adapt_s, "balance_s": balance_s,
        "finite": bool(np.isfinite(rho).all()),
    }
    ex = ga.halo()
    field = {"density": sa["density"]}
    b0 = ex.transport_bytes
    _, b9_x, _, _, secs_x = counted(lambda: [ex(field) for _ in range(size["reps"])])
    res["exchange"] = {"wall_ms": secs_x / size["reps"] * 1e3,
                       "b9": b9_x / size["reps"],
                       "transport_bytes": (ex.transport_bytes - b0) / size["reps"]}

    path = os.path.join(wd, f"spmd_{nproc}x{D // nproc}_{ctl.multi}.dc")
    ga.save_grid_data(sa, path, adv.spec)
    g3, s3, _ = Grid.load_grid_data(path, adv.spec, n_devices=D, device=device)
    reloaded = g3.get_cell_data(s3, "density", cells)
    with open(path, "rb") as f:
        res["ckpt"] = {"file_hash": h(np.frombuffer(f.read(), np.uint8)),
                       "reload_equal": bool(np.array_equal(reloaded, rho))}
    barrier("spmd.ckpt")
    del ga, adv, sa, g3, s3
    if dense is not None:
        res["dense"] = spmd_dense(ctl, nproc, device, SPMD_DENSE[dense])
    res["models"] = spmd_models(ctl, nproc, D, device, SPMD_MODELS[
        "full" if size == SPMD_SIZES["full"] else "small"](D))
    res["s"] = time.perf_counter() - t0
    from dccrg_tpu_torch.parallel.transport import STAGED

    # the pinned host bytes (and stream synchronisations) this controller's
    # transport staged: gloo's, never ipc's or nccl's
    res["staged"] = dict(STAGED)
    res["arena"] = _arena_record(ctl)
    return res


def _arena_record(ctl):
    """Under ipc, the arena's allocations (1: never grown) and channel
    bytes; None on the other transports."""
    arena = getattr(ctl, "arena", None)
    return None if arena is None else [arena.epoch, arena.cap]


def spmd_models(ctl, nproc, D, device, widths) -> dict:
    """Phase 32's models (D2, D4, D5) on the controllers ``ctl``
    (``mesh.SINGLE``: the oracle on the same D slots): Poisson through the
    flat voxel operator (its z-rolls' end planes over the ring) and the
    rolled one (ghosts through B9 and the transport), particles on the
    refined, balanced grid (two exchanges a step, B9 on each), and the
    refined run's ``sharded`` and ``ml`` flat forms and boxed passes on the
    ring.  Each case's timed part runs with the counts at 0.  Returns, a
    case: hashes of the result by cell id, the form that engaged, the
    launches and twin calls, the ring or transport bytes and wall ms a step
    (an iteration)."""
    import hashlib

    import numpy as np

    from dccrg_tpu_torch import Advection, CartesianGeometry, Grid, Particles, Poisson
    from dccrg_tpu_torch.utils.collectives import fetch

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    def grid(n, radii, center, max_ref, lb, hood=0):
        g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(hood)
             .set_periodic(True, True, True).set_maximum_refinement_level(max_ref)
             .set_load_balancing_method(lb)
             .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / n,) * 3)
             .initialize(n_devices=D, device=device, controllers=ctl))
        for rad in radii:
            ids = g.get_cells()
            r = np.linalg.norm(g.geometry.get_center(ids) - np.asarray(center), axis=1)
            lv = g.mapping.get_refinement_level(ids)
            g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
            g.stop_refining()
        return g

    def drive(fn, counter, steps):
        return spmd_drive(device, fn, steps, counter)

    out = {}
    # Poisson: the flat voxel operator (BLOCK) and the rolled one
    for case, lb, kw in (("poisson", "BLOCK", {}),
                         ("poisson_rolled", SPMD_ROLLED_LB[D],
                          {"allow_flat": False, "allow_rolled": True})):
        iters = SPMD_MODEL_STEPS[case]
        g = grid(widths["poisson"], (0.25,), (0.5, 0.5, 0.5), 1, lb)
        cells = g.get_cells()
        c = g.geometry.get_center(cells)
        rhs = np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
        p = Poisson(g, dtype=np.float32, **kw)
        s = p.initialize_state(rhs - rhs.mean())
        ring = p._flat_ring if p._flat_ring is not None else p._exchange
        counter = (lambda: 0) if ring is None else (lambda r=ring: r.transport_bytes)
        (o, res, it), rec = drive(lambda: p.solve(
            s, max_iterations=iters, stop_residual=0.0,
            stop_after_residual_increase=float("inf")), counter, iters)
        sol = g.get_cell_data(o, "solution", cells)
        rec.update(hashes={"solution": h(sol), "iterations": int(it), "residual": float(res)},
                   form=p.operator_space, n_leaves=len(cells),
                   finite=bool(np.isfinite(sol).all()))
        out[case] = rec
        del g, p, s, o
    # particles on the refined, HSFC-balanced grid
    n_pts, n_pic = widths["pic"]
    g = grid(n_pic, (0.25,), (0.5, 0.5, 0.5), 1, "HSFC", hood=1)
    g.balance_load()
    pts = np.random.default_rng(1).uniform(0.0, 1.0, size=(n_pts, 3))
    occ = np.bincount(g.leaves.position(g.get_existing_cell(pts)))
    pc = Particles(g, max_particles_per_cell=2 * int(occ.max()))
    vel = pc.velocity_field(lambda c: np.stack(
        [0.5 - c[:, 1], c[:, 0] - 0.5, np.full(len(c), 0.05)], axis=-1))
    s = pc.new_state(pts)
    steps = SPMD_MODEL_STEPS["pic_refined_lb"]
    o, rec = drive(lambda: pc.run(s, steps, velocity=vel, dt=0.1 / n_pic),
                   lambda: pc._exchange.transport_bytes, steps)
    cells = g.get_cells()
    pos = g.leaves.position(cells)
    d, r = g.leaves.owner[pos], g.epoch.row_of[pos]
    cnt = fetch(o["number_of_particles"])[d, r]
    xyz = fetch(o["particles"])[d, r]
    xyz[np.arange(pc.P)[None, :] >= cnt[:, None]] = 0
    rec.update(hashes={"counts": h(cnt), "coords": h(xyz), "count": pc.count(o),
                       "lost": pc.lost(o)},
               form="device" if pc._dev_rebucket is not None else "host",
               n_leaves=len(cells), P=pc.P, finite=bool(np.isfinite(xyz).all()))
    out["pic_refined_lb"] = rec
    del g, pc, s, o, xyz
    # the refined run's flat forms and boxed passes (BLOCK: the z-slabs)
    for case in ("sharded", "boxed", "ml"):
        if case == "ml":
            n3, radii = widths["refined3"]
            g = grid(n3, radii, (0.5, 0.5, 0.5), 2, "BLOCK")
            dtype = np.float64
        else:
            g = grid(widths["refined"], (0.3,), (0.3, 0.5, 0.5), 1, "BLOCK")
            dtype = np.float32
        adv = Advection(g, dtype=dtype)
        s = adv.initialize_state()
        dt = 0.4 * adv.max_time_step(s)
        run = adv._boxed_run if case == "boxed" else adv._flat_run.run
        steps = SPMD_MODEL_STEPS[case]
        o, rec = drive(lambda: run(s, steps, dt), lambda: run.ring.transport_bytes, steps)
        cells = g.get_cells()
        rho = g.get_cell_data(o, "density", cells)
        rec.update(hashes={"density": h(rho)}, form=adv._flat_kind,
                   prefer_boxed=adv._prefer_boxed, n_leaves=len(cells),
                   finite=bool(np.isfinite(rho).all()))
        out[case] = rec
        del g, adv, s, o
    return out


def spmd_dense(ctl, nproc, device, widths) -> dict:
    """Phase 32's dense cases (SPMD_DENSE_LAYOUT) of ``nproc`` controllers,
    on the controllers ``ctl`` (``mesh.SINGLE``: the oracle on the same
    slots): the headline through B2 with the ring planes from the transport
    each step and the vz planes once a run, the plane grid through B3, the
    board through the torch dense loop, Vlasov through B7 with the ring's
    edge planes (its explicit-edge mode), and Vlasov's gather step on the
    refined grid.  Each case takes one step (turn) untimed, then its run
    with the counts at 0.  Returns, a case: hashes of this controller's
    slots' result (slot -> hash; the board's alive set and vlasov_amr's f
    by cell id whole), the launches and twin calls of the run, its ring
    bytes and wall ms a step."""
    import hashlib

    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, CartesianGeometry, GameOfLife, Grid, Vlasov

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    def grid(length, D, periodic=(True, True, True), hood=0, max_ref=0):
        return (Grid().set_initial_length(length).set_neighborhood_length(hood)
                .set_periodic(*periodic).set_maximum_refinement_level(max_ref)
                .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                              level_0_cell_length=tuple(1.0 / n for n in length))
                .initialize(n_devices=D, device=device, controllers=ctl))

    def per_slot(g, t):
        a = t.detach().cpu().numpy()
        return {str(d): h(a[i]) for i, d in enumerate(g.slots)}

    def drive(fn, ring, steps):
        return spmd_drive(device, fn, steps, lambda: ring.transport_bytes)

    out = {}
    cases = [c for c, (p, _) in SPMD_DENSE_LAYOUT.items() if p == nproc]
    for case in cases:
        D = nproc * SPMD_DENSE_LAYOUT[case][1]
        steps = SPMD_DENSE_STEPS[case]
        if case in ("headline", "plane"):
            g = grid(widths[case], D)
            adv = Advection(g, dtype=np.float32)
            s = adv.initialize_state()
            dt = 0.4 * adv.max_time_step(s)
            g.halo(None)        # the run's telemetry record reads it: built here
            s = adv.step(s, dt)
            if case == "headline":
                s, rec = drive(lambda: adv.run(s, steps, dt), adv._extend, steps)
            else:
                s, rec = drive(lambda: adv.run(adv.step(s, dt), steps, dt),
                               adv._extend, steps + 1)
            rec.update(hashes=per_slot(g, s["density"]), kind=list(adv.dense_kind),
                       fused=adv.fused, plane_bytes=g.length[0] * g.length[1] * 4,
                       finite=bool(torch.isfinite(s["density"]).all()))
            del g, adv, s
        elif case == "board":
            n = widths[case]
            g = (Grid().set_initial_length((n, n, 1)).set_neighborhood_length(1)
                 .initialize(n_devices=D, device=device, controllers=ctl))
            cells = g.get_cells()
            gol = GameOfLife(g)
            s = gol.new_state(alive_cells=cells[np.random.default_rng(0).random(len(cells))
                                                < 0.3])
            s = gol.run(s, 1)
            s, rec = drive(lambda: gol.run(s, steps), gol._ring, steps)
            rec.update(hashes={"alive": h(np.sort(gol.alive_cells(s)))},
                       dense=gol.dense2d is not None, fused=gol.fused,
                       plane_bytes=n * 4, finite=True)
            del g, gol, s
        else:
            if case == "vlasov":
                length, nv = widths[case]
                g = grid(length, D)
            else:
                m, nv = widths[case]
                g = grid((m, m, m), D, max_ref=1)
                ids = g.get_cells()
                g.refine_completely_many(ids[np.linalg.norm(
                    g.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
                g.stop_refining()
            vl = Vlasov(g, nv=nv, dtype=np.float32)
            s = vl.initialize_state()
            dt = 0.4 * vl.max_time_step()
            ring = vl._extend if vl.info is not None else g.halo(None)
            s = vl.step(s, dt)
            s, rec = drive(lambda: vl.run(s, steps, dt), ring, steps)
            if vl.info is not None:
                hashes = per_slot(g, s["f"])
                plane = g.length[0] * g.length[1] * vl.B * 4
            else:
                ids = g.get_cells()
                hashes = {"f": h(g.get_cell_data(s, "f", ids)), "n_leaves": len(ids)}
                plane = 0
            rec.update(hashes=hashes, fused_block=vl._fused_block, plane_bytes=plane,
                       dense=vl.info is not None,
                       finite=bool(torch.isfinite(s["f"]).all()))
            del g, vl, s
        out[case] = rec
    return out


def child_spmd(wd, D, backend, size, device, dense) -> int:
    """One controller of phase 32: join the group (``torchrun``'s
    environment, set by ``mesh.launch``), run :func:`spmd_run`, print its
    ``RESULT`` line."""
    from dccrg_tpu_torch.parallel import mesh

    ctl = mesh.setup(backend=backend, device=None if device == "cuda" else device)
    try:
        res = spmd_run(ctl, ctl.size, D, wd, ctl.device, SPMD_SIZES[size], dense)
    finally:
        mesh.teardown()
    mesh.result(res)
    return 0


def child_spmd33(wd, part, size, device, backend="gloo") -> int:
    """One controller of phase 33 (``--child spmd33 wd part size device
    [backend]``): ``serve`` runs the split cases and the cohorts of this
    controller count and writes its result to ``wd/serve33_<rank>.json``
    before the killed lineage run (its controller 1 dies there, so the
    launch fails by design); ``plane`` runs the 3 x 1 cohort and ``resume``
    the lineage's relaunch; ``ipc`` (phase 34) the split cases and
    SPMD34_COHORTS, with B9's remote-write timing under the ipc transport;
    each but ``serve`` prints its ``RESULT`` line."""
    from dccrg_tpu_torch.parallel import mesh
    from dccrg_tpu_torch.parallel.transport import STAGED

    ctl = mesh.setup(backend=backend, device=None if device == "cuda" else device)
    dev = ctl.device
    sz = SPMD33[size]
    try:
        if part == "ipc":
            t0 = time.perf_counter()
            res = {"rank": ctl.rank, "backend": ctl.backend,
                   "split": spmd33_split(ctl, 8, dev, sz, put_timing=True),
                   "cohorts": {c: spmd33_cohort(ctl, c, dev, sz) for c in SPMD34_COHORTS},
                   "round_trip": host_round_trips(ctl)}
            res["s"] = time.perf_counter() - t0
            res["staged"] = dict(STAGED)
            res["arena"] = _arena_record(ctl)
        elif part == "serve":
            t0 = time.perf_counter()
            res = {"rank": ctl.rank, "split": spmd33_split(ctl, 8, dev, sz),
                   "cohorts": {c: spmd33_cohort(ctl, c, dev, sz) for c, v
                               in SPMD33_COHORTS.items() if v[0] == ctl.size},
                   "ensemble": spmd33_ensemble(ctl, dev, sz)}
            res["s"] = time.perf_counter() - t0
            _write_json(os.path.join(wd, f"serve33_{ctl.rank}.json"), res)
            spmd33_lineage(ctl, 8, dev, sz, wd, "kill")
            res = {"rank": ctl.rank, "killed": False}
        elif part == "plane":
            res = {"rank": ctl.rank, "plane": spmd33_cohort(ctl, "plane", dev, sz)}
        else:
            res = {"rank": ctl.rank, "lineage": spmd33_lineage(ctl, 8, dev, sz, wd, "resume")}
    finally:
        mesh.teardown()
    mesh.result(res)
    return 0


def child_main(argv) -> int:
    if argv[0] == "spmd":
        return child_spmd(argv[1], int(argv[2]), argv[3], argv[4], argv[5], argv[6])
    if argv[0] == "spmd33":
        return child_spmd33(*argv[1:6])
    kind, wd, device = argv[0], argv[1], argv[2]
    if kind == "headline":
        child_headline(wd, device)
    elif kind == "gol":
        child_gol(wd, device, int(argv[3]), argv[4])
    else:
        raise SystemExit(f"unknown child {kind!r}")
    return 0


def launch_child(wd, args, env_extra=None):
    """``python3 chip_smoke.py --child <args>`` from the checkout, its
    output into ``wd/child.log`` (a fresh interpreter: no CUDA context is
    shared with this process)."""
    env = dict(os.environ)
    env.pop("DCCRG_FAULT", None)
    env.update(env_extra or {})
    log = open(os.path.join(wd, "child.log"), "a")
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", *map(str, args)],
                         cwd=here, stdout=log, stderr=subprocess.STDOUT, env=env)
    return p, log


def child_log(wd, n=3000):
    with open(os.path.join(wd, "child.log")) as f:
        return f.read()[-n:]


def spmd_check(res, one, nproc, per, backend, size, device, card, tag="[spmd]"):
    """Phase 32's checks of the controllers' results ``res`` (``--child
    spmd`` of ``nproc`` x ``per`` slots over ``backend``) against the
    one-controller oracle ``one`` on the same slots, and their log lines
    (``tag`` first): the gather part's hashes, B9 on every controller and no
    twin, then the dense cases and the models."""
    D = nproc * per
    keys = lambda r: (r["gol"]["alive_hash"], r["gol"]["n_alive"], r["n_leaves"],
                      r["advection"]["rho_hash"], r["advection"]["owners_hash"],
                      r["advection"]["n_leaves"], r["ckpt"]["file_hash"])
    for r in res:
        check(keys(r) == keys(one),
              f"spmd {nproc}x{per} {backend}: controller {r['rank']} {keys(r)} != "
              f"one controller {keys(one)}")
        check(r["ckpt"]["reload_equal"] and r["advection"]["finite"],
              f"spmd {nproc}x{per} {backend}: reload or finiteness")
        for part in ("gol", "advection"):
            # (a rehearsal on the CPU runs the twins: nothing launches)
            check(device != "cuda" or (r[part]["b9"] > 0 and not r[part]["others"]
                                       and not r[part]["plain"]),
                  f"spmd {nproc}x{per} {backend} {part}: controller {r['rank']} B9 "
                  f"{r[part]['b9']}, others {r[part]['others']}, twins {r[part]['plain']}")
        check(device != "cuda" or r["exchange"]["b9"] == 2,
              f"spmd: {r['exchange']['b9']} B9 launches an exchange")
        log(f"{tag} transport {backend}, {nproc} controllers x {per} slots, controller "
            f"{r['rank']}: gol {SPMD_SIZES[size]['turns']} turns {r['gol']['s']!r} s, "
            f"B9 launches {r['gol']['b9']}, transport bytes {r['gol']['transport_bytes']}; "
            f"advection {r['advection']['n_leaves']} leaves, "
            f"{2 * SPMD_SIZES[size]['steps']} steps {r['advection']['steps_s']!r} s, "
            f"B9 launches {r['advection']['b9']}, adapt_grid {r['advection']['adapt_s']!r} s "
            f"({r['advection']['new_cells']} new cells), balance_load + remap "
            f"{r['advection']['balance_s']!r} s; blocking density exchange wall "
            f"{r['exchange']['wall_ms']!r} ms, transport bytes "
            f"{r['exchange']['transport_bytes']!r} an exchange, B9 launches "
            f"{r['exchange']['b9']!r} an exchange; pinned host bytes staged "
            f"{r['staged']['bytes']} in {r['staged']['syncs']} stream synchronisations; "
            f"controller seconds {r['s']!r} on {card}")
    log(f"{tag} one controller x {D} slots: gol {one['gol']['s']!r} s "
        f"(B9 launches {one['gol']['b9']}), advection steps {one['advection']['steps_s']!r} s, "
        f"blocking density exchange wall {one['exchange']['wall_ms']!r} ms "
        f"(B9 launches {one['exchange']['b9']!r} an exchange); oracle seconds "
        f"{one['s']!r}; {nproc}x{per} {backend} bitwise equal: alive set "
        f"{one['gol']['alive_hash']}, density {one['advection']['rho_hash']}, owners "
        f"{one['advection']['owners_hash']}, checkpoint {one['ckpt']['file_hash']}")
    spmd_dense_check(res, one, nproc, backend, device, card)
    spmd_models_check(res, one, nproc, backend, device, card)


def spmd_phase(dev, card, device="cuda"):
    """Phase 32: the multi-controller gather path (``parallel/mesh.py``).
    SPMD_CONTROLLERS controllers of SPMD_SLOTS / SPMD_CONTROLLERS slots each,
    on one card over gloo, run :func:`spmd_run` at the bench's widths while
    this process runs the one-controller oracle on SPMD_SLOTS slots; every
    controller's hashes (alive set, density by cell id, owners, checkpoint
    bytes) must equal each other's and the oracle's, B9 must launch on each
    controller in each part and no twin run.  Then 3 controllers x 2 slots
    on the small sizes, and nccl with a card a controller where the machine
    has two.  Any failure raises; the phase's seconds are logged beside its
    budget."""
    import shutil
    import threading

    from dccrg_tpu_torch.parallel import halo_dma, mesh

    t_phase = time.perf_counter()
    if device == "cuda":
        from dccrg_tpu_torch.ops import dense_advection, vlasov_kernel

        # built once here, before the controllers start
        for build in (halo_dma._kernels, dense_advection._kernels,
                      vlasov_kernel._kernels):
            build()
    wd = tempfile.mkdtemp(prefix="spmd_")
    env = {"DCCRG_HALO_BACKEND": "auto", "DCCRG_HALO_VERIFY": "0", "DCCRG_FAULT": ""}

    # the dense kernels, like B9, built once before the controllers start
    dense = "full" if device == "cuda" else "small"

    def run(nproc, per, backend, size):
        D = nproc * per
        argv = [sys.executable, os.path.abspath(__file__), "--child", "spmd", wd,
                str(D), backend, size, device, dense]
        got = {}
        th = threading.Thread(target=lambda: got.update(
            r=mesh.launch(argv, nproc, timeout_s=240, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))))
        th.start()
        try:
            one = spmd_run(mesh.SINGLE, nproc, D, wd, dev, SPMD_SIZES[size], dense)
        finally:
            th.join()
        check("r" in got, f"spmd {nproc}x{per} {backend}: the controllers failed "
              "(see the traceback above)")
        spmd_check(got["r"], one, nproc, per, backend, size, device, card)
        return got["r"], one
    try:
        # a rehearsal on the CPU keeps to the small sizes
        full = run(SPMD_CONTROLLERS, SPMD_SLOTS // SPMD_CONTROLLERS, "gloo",
                   "full" if device == "cuda" else "small")
        run(3, 2, "gloo", "small")
        import torch

        if device == "cuda" and torch.cuda.device_count() >= 2:
            run(2, 4, "nccl", "full")
        else:
            log(f"[spmd] transport nccl: not run: it needs a card a controller and "
                f"this machine has {torch.cuda.device_count() if device == 'cuda' else 0} "
                "(NCCL refuses two ranks on one card)")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[spmd] phase seconds {secs!r} (budget {SPMD_BUDGET_S!r}) on {card}")
    return {"res": full[0], "one": full[1]}


#: phase 34's cohorts (of SPMD33_COHORTS): the dense ring's and Vlasov's
#: member planes and the split cohort's member tables through the ipc arenas
SPMD34_COHORTS = ("dense", "vlasov", "split")
#: phase 34's budget: phase 32's 2 x 4 run and phase 33's split cases and
#: SPMD34_COHORTS, over gloo and then over ipc, process start-ups included
SPMD34_BUDGET_S = 150.0


def ipc_put_timing(ctl, ex, state, reps=200) -> dict | None:
    """B9's remote-write form (``halo_dma.ring_put``) at this controller's
    pack of ``state`` under the ipc transport, as the split step's start
    writes it: the local rows into this controller's own arena, each peer's
    rows into that peer's arena (another process's memory mapped through
    CUDA IPC: on the same card, or on another over peer access where the
    controllers have a card each).  Controller 0 times it alone with CUDA events
    (the others wait at a barrier), the timed launches queued behind a
    device-side sleep as long as their host-side issue, beside the twin and
    beside the same launch with every destination in its own arena
    (``local_ms``: the cost of the peer's mapping), and holds the kernel's
    rows bitwise against the twin's; the bound counts each row read once and
    written once and its 4-byte table entry, at HBM_BYTES_PER_S.  Returns
    rows, rows to peers, bytes, launches, ms, twin ms, local ms, bound ms
    and the equality on controller 0, None on the others."""
    import torch

    from dccrg_tpu_torch.parallel import halo_dma
    from dccrg_tpu_torch.utils.collectives import barrier

    arena = ex._transport.arena
    placed, jobs = {}, []
    rows = remote = nbytes = 0
    for _, x, rings in ex._moving(state):
        rb, row = ex._per_cell_bytes(x), tuple(x.shape[2:])
        for q, a, n in [(None, 0, rings.n_local)] + list(rings.sends):
            if n:
                placed.setdefault(q, []).append((x, rings.send[a:a + n], n, rb, row))
                rows += n
                remote += 0 if q is None else n
                nbytes += n * (2 * rb + 4)
    local = []
    for i, (q, items) in enumerate(placed.items()):
        pos = arena._layout(arena.rank, 0, [(n * rb, rb) for _, _, n, rb, _ in items])
        buf = arena.mine if q is None else arena.peers[q]
        jobs += [(x, t, arena._view(buf, p, x.dtype, (n,) + row))
                 for (x, t, n, rb, row), p in zip(items, pos)]
        # the same rows into this controller's own arena: channel i, parity 1
        pos = arena._layout(i, 1, [(n * rb, rb) for _, _, n, rb, _ in items])
        local += [(x, t, arena._view(arena.mine, p, x.dtype, (n,) + row))
                  for (x, t, n, rb, row), p in zip(items, pos)]
    barrier("ipc.put")
    out = None
    if ctl.rank == 0:
        def timed(fn, jobs=jobs):
            for _ in range(10):
                fn(jobs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(jobs)
            torch.cuda.synchronize()
            issue_s = min(1.5 * reps * (time.perf_counter() - t), 2.0)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(issue_s * 2e9))     # cycles at <= 2 GHz
            e0.record()
            for _ in range(reps):
                fn(jobs)
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / reps

        halo_dma.ring_put(jobs)
        got = [d.clone() for _, _, d in jobs]
        halo_dma.ring_put_plain(jobs)
        equal = all(torch.equal(a, d) for a, (_, _, d) in zip(got, jobs))
        out = {"rows": rows, "remote_rows": remote, "bytes": nbytes,
               "cards": sorted({str(arena.mine.device)} | {str(p.device) for p in
                                                           arena.peers.values()}),
               "launches": -(-len(jobs) // halo_dma.RING_MAX_FIELDS), "equal": bool(equal),
               "ms": timed(halo_dma.ring_put), "plain_ms": timed(halo_dma.ring_put_plain),
               "local_ms": timed(halo_dma.ring_put, local),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    barrier("ipc.put.done")
    return out


def host_round_trips(ctl, n=200) -> dict:
    """The host round trip between controllers 0 and 1, ms (the mean of
    ``n`` ping-pongs of a 16-byte message): gloo's point-to-point on the
    host group and, under ipc, the arenas' token sockets
    (``parallel/ipc.py``)."""
    import torch
    import torch.distributed as dist

    from dccrg_tpu_torch.utils.collectives import barrier

    out = {}
    buf = torch.zeros(2, dtype=torch.int64)
    peer = 1 - ctl.rank
    arena = getattr(ctl, "arena", None)

    def gloo():
        if ctl.rank == 0:
            dist.send(buf, peer, group=ctl.host_group)
            dist.recv(buf, peer, group=ctl.host_group)
        elif ctl.rank == 1:
            dist.recv(buf, peer, group=ctl.host_group)
            dist.send(buf, peer, group=ctl.host_group)

    def sockets():
        if ctl.rank == 0:
            arena._tokens.send(peer, 99, 0)
            arena._tokens.recv(peer, 99)
        elif ctl.rank == 1:
            arena._tokens.recv(peer, 99)
            arena._tokens.send(peer, 99, 0)

    for name, fn in (("gloo", gloo), ("sockets", sockets if arena is not None else None)):
        if fn is None:
            continue
        for _ in range(10):
            fn()
        barrier("ipc.rtt")
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t) / n * 1e3
    return out


def spmd33_split_check(res, one, device, card, tag="[spmd serve]", transport="gloo"):
    """Phase 33's split cases (``--child spmd33`` results ``res`` of 2 x 4
    over ``transport``) against the oracle's ``one``: bitwise by cell id,
    finite, B9 twice a step in the split and the blocking runs and no twin
    (on the card), bytes crossed; a line a controller."""
    for case, want in one["split"].items():
        steps = SPMD33_SPLIT_STEPS[case]
        for r in res:
            rec = r["split"][case]
            check(rec["hashes"] == want["hashes"], f"spmd33 split {case} {transport}: a "
                  f"controller {rec['hashes']} != one controller {want['hashes']}")
            check(rec["finite"], f"spmd33 split {case}: non-finite")
            for mode in ("split", "blocking"):
                check(device != "cuda" or (rec[mode]["launches"] == {"ring_copy": 2 * steps}
                                           and not rec[mode]["plain"]),
                      f"spmd33 split {case} {mode} {transport} controller {r['rank']}: "
                      f"launches {rec[mode]['launches']}, twins {rec[mode]['plain']}")
            check(rec["split"]["bytes"] > 0, f"spmd33 split {case}: nothing crossed")
            log(f"{tag} split {case} ({rec['n_leaves']} leaves), 2 controllers x 4 slots "
                f"({transport}), controller {r['rank']}: split {rec['split']['ms']!r} ms a "
                f"step, blocking {rec['blocking']['ms']!r} ms a step, B9 launches "
                f"{rec['split']['launches'].get('ring_copy', 0)} in {steps} split steps, "
                f"transport bytes a step {rec['split']['bytes'] / steps!r}; one controller "
                f"x 8 slots: split {want['split']['ms']!r}, blocking "
                f"{want['blocking']['ms']!r} ms a step; bitwise equal on {card}")


def spmd33_cohort_check(case, recs, want, device, card, tag="[spmd serve]",
                        transport="gloo"):
    """One of phase 33's cohorts: every member bitwise the oracle's, finite,
    its kernel once a step for all W members (B9 twice a split step, once
    a wide exchange), no twin (on the card), bytes crossed; a line a
    controller."""
    kernel = {"dense": "flux_update_blocked", "plane": "flux_update",
              "vlasov": "vlasov_step"}
    nproc, per, W, steps, k = SPMD33_COHORTS[case]
    for r in recs:
        rec = r[case] if case in r else r["cohorts"][case]
        check(rec["members"] == want["members"], f"spmd33 cohort {case} {transport}: a "
              f"controller {rec['members']} != one controller {want['members']}")
        check(rec["finite"], f"spmd33 cohort {case}: non-finite")
        if case in kernel:
            # the member axis: one launch a step for all W members
            exp = {kernel[case]: steps}
        elif case == "split":
            exp = {"ring_copy": 2 * steps}
        else:
            # one wide exchange (pack and merge) every g steps of a
            # dispatch of k
            exp = {"ring_copy": 2 * -(-k // rec["g"]) * -(-steps // k)}
        check(device != "cuda" or (rec["rec"]["launches"] == exp and not rec["rec"]["plain"]),
              f"spmd33 cohort {case} {transport} controller {r['rank']}: launches "
              f"{rec['rec']['launches']}, twins {rec['rec']['plain']}, expected {exp}")
        check(rec["rec"]["bytes"] > 0, f"spmd33 cohort {case}: nothing crossed")
        log(f"{tag} cohort {case} ({rec['kind']}, form {rec['form']}) W={W} k={k}, "
            f"{nproc} controllers x {per} slots ({transport}), controller {r['rank']}: "
            f"launches {rec['rec']['launches']} in {steps} steps, {rec['rec']['ms']!r} ms a "
            f"step, transport bytes a step {rec['rec']['bytes'] / steps!r}; one controller: "
            f"{want['rec']['ms']!r} ms a step; every member bitwise equal to the oracle's "
            f"on {card}")


def _ipc_cases(r32, r34):
    """Controller 0's wall ms and transport bytes of each phase 34 case:
    {case: (ms, bytes, unit)}."""
    a, b = r32[0], r34[0]
    out = {"density exchange": (a["exchange"]["wall_ms"], a["exchange"]["transport_bytes"],
                                "an exchange")}
    for case, rec in a.get("dense", {}).items():
        out[f"dense {case}"] = (rec["ms"], rec["bytes"] / rec["steps"], "a step")
    for case, rec in a["models"].items():
        unit = "an iteration" if case.startswith("poisson") else "a step"
        out[f"model {case}"] = (rec["ms"], rec["bytes"] / rec["steps"], unit)
    for case, rec in b["split"].items():
        steps = SPMD33_SPLIT_STEPS[case]
        for mode in ("split", "blocking"):
            out[f"{mode} {case}"] = (rec[mode]["ms"], rec[mode]["bytes"] / steps, "a step")
    for case, rec in b["cohorts"].items():
        out[f"cohort {case}"] = (rec["rec"]["ms"], rec["rec"]["bytes"] / SPMD33_COHORTS[case][3],
                                 "a step")
    return out


def ipc_phase(dev, card, o32, o33, device="cuda"):
    """Phase 34: the device-direct transport (D8, ``DCCRG_TORCH_DIST_BACKEND=
    ipc``).  Phase 32's 2 x 4 run (the gather case, the dense cases through
    B2 and B7, the models) and phase 33's split cases and SPMD34_COHORTS run
    on 2 controllers of one card over gloo and then over ipc, each launch
    alone on the card (no oracle beside it); every result must equal the
    one-controller oracle's hashes of phases 32 and 33 (``o32``, ``o33``),
    B9 must launch on each controller with no twin, and under ipc no
    pinned host byte may be staged.  Each case's wall ms and transport
    bytes are logged under both transports, and B9's remote-write form is
    timed at the split advection and Vlasov payloads
    (:func:`ipc_put_timing`).  Any failure raises; the phase's seconds are
    logged beside its budget."""
    import shutil

    from dccrg_tpu_torch.parallel import halo_dma, ipc, mesh

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        from dccrg_tpu_torch.ops import dense_advection, vlasov_kernel

        for build in (halo_dma._kernels, dense_advection._kernels,
                      vlasov_kernel._kernels, ipc._cuda):
            build()
    size = "full" if cuda else "small"
    wd = tempfile.mkdtemp(prefix="spmd34_")
    env = {"DCCRG_HALO_BACKEND": "auto", "DCCRG_HALO_VERIFY": "0", "DCCRG_FAULT": "",
           "DCCRG_ENSEMBLE_VERIFY": "0"}
    if not cuda:
        env["OMP_NUM_THREADS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    nproc, per = SPMD_CONTROLLERS, SPMD_SLOTS // SPMD_CONTROLLERS
    me = [sys.executable, os.path.abspath(__file__), "--child"]
    out = {}
    try:
        for backend in ("gloo", "ipc"):
            t0 = time.perf_counter()
            r32 = mesh.launch(me + ["spmd", wd, str(nproc * per), backend, size, device,
                                    size], nproc, timeout_s=300, env=env, cwd=here)
            r34 = mesh.launch(me + ["spmd33", wd, "ipc", size, device, backend], nproc,
                              timeout_s=300, env=env, cwd=here)
            secs = time.perf_counter() - t0
            spmd_check(r32, o32, nproc, per, backend, size, device, card, tag="[ipc]")
            spmd33_split_check(r34, o33, device, card, "[ipc]", backend)
            for case in SPMD34_COHORTS:
                spmd33_cohort_check(case, [{"rank": r["rank"], **r["cohorts"]} for r in r34],
                                    o33["cohorts"][case], device, card, "[ipc]", backend)
            staged = [(r["staged"]["bytes"], r["staged"]["syncs"]) for r in r32 + r34]
            check(backend != "ipc" or all(s == (0, 0) for s in staged),
                  f"ipc: pinned host bytes staged under ipc: {staged}")
            log(f"[ipc] transport {backend}: host round trip between controllers 0 and 1, "
                f"ms: {r34[0]['round_trip']!r}; arena allocations and channel bytes a "
                f"controller (phase 32's run, phase 33's cases; 1 allocation: never grown) "
                f"{[r['arena'] for r in r32 + r34]!r} on {card}")
            log(f"[ipc] transport {backend}: every case bitwise equal to one controller on "
                f"the same slots; B9 on each controller, no twin; pinned host bytes staged "
                f"and stream synchronisations (a controller, phase 32's run then phase 33's "
                f"cases) {staged}; {secs!r} s for both launches on {card}")
            out[backend] = _ipc_cases(r32, r34)
            if backend == "ipc":
                puts = {case: r34[0]["split"][case].get("put") for case in ("advection",
                                                                            "vlasov")}
        for case, (ms_g, by_g, unit) in out["gloo"].items():
            ms_i, by_i, _ = out["ipc"][case]
            log(f"[ipc] {case}, controller 0: gloo {ms_g!r} ms {unit} ({by_g!r} transport "
                f"bytes), ipc {ms_i!r} ms ({by_i!r} bytes); gloo / ipc {ms_g / ms_i!r} "
                f"on {card}")
        for case, put in puts.items():
            if not cuda:
                continue
            check(put is not None and put["equal"],
                  f"ipc: B9's remote write at the split {case} payload: {put}")
            log(f"[ipc] B9 remote write (ring_put) at the split_{case} payload of controller "
                f"0 ({put['rows']} rows, {put['remote_rows']} of them into controller 1's "
                f"arena; the arenas on {put['cards']}, {put['launches']} launch): "
                f"{put['ms']!r} ms, twin "
                f"{put['plain_ms']!r} ms, every row into its own arena instead "
                f"{put['local_ms']!r} ms, bound {put['bound_ms']!r} ms (bytes: "
                f"{put['bytes']}), kernel bitwise equal to the twin on {card}")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[ipc] phase 34 seconds {secs!r} (budget {SPMD34_BUDGET_S!r}) on {card}")
    return out


def spmd_serve_phase(dev, card, device="cuda"):
    """Phase 33: the split steps (D6), the cohorts (D7) and the lineage (D9)
    across controllers, on one card over gloo.  Three launches of
    ``--child spmd33``: 2 controllers x 4 slots run the split cases, the
    cohorts of two controllers and the deadline ensemble, then the
    headline's lineage run, where controller 1 dies after its second commit
    (the launch fails by design; each controller wrote its results first);
    3 x 1 run the plane cohort; 2 x 4 relaunch the lineage from
    ``latest_valid``, rescale it to 2 x 2 and finish.  This process runs
    the one-controller oracle of each beside it on the same slots (members
    also against their solo runs).  Every controller must equal the oracle
    bitwise, launch B9 in the split cases and the split cohort, and launch
    B2, B3 and B7 once a step for all W members; the resumed, rescaled run
    must end bitwise equal to the uninterrupted one.  Any failure raises;
    the phase's seconds are logged beside its budget."""
    import shutil
    import threading

    from dccrg_tpu_torch.parallel import halo_dma, mesh

    t_phase = time.perf_counter()
    if device == "cuda":
        from dccrg_tpu_torch.ops import dense_advection, vlasov_kernel

        for build in (halo_dma._kernels, dense_advection._kernels,
                      vlasov_kernel._kernels):
            build()
    size = "full" if device == "cuda" else "small"
    sz = SPMD33[size]
    wd = tempfile.mkdtemp(prefix="spmd33_")
    env = {"DCCRG_HALO_BACKEND": "auto", "DCCRG_HALO_VERIFY": "0", "DCCRG_FAULT": "",
           "DCCRG_ENSEMBLE_VERIFY": "0"}
    if device != "cuda":
        env["OMP_NUM_THREADS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    cuda = device == "cuda"

    def launch(part, nproc, oracle):
        """``part`` on ``nproc`` controllers while ``oracle()`` runs here:
        (the controllers' results or the launch's error, the oracle's)."""
        argv = [sys.executable, os.path.abspath(__file__), "--child", "spmd33", wd, part,
                size, device]
        got = {}

        def run():
            try:
                got["r"] = mesh.launch(argv, nproc, timeout_s=300, env=env, cwd=here)
            except RuntimeError as e:
                got["err"] = str(e)

        th = threading.Thread(target=run)
        th.start()
        try:
            one = oracle()
        finally:
            th.join()
        return got, one

    def same(label, got, want):
        check(got == want, f"spmd33 {label}: a controller {got} != one controller {want}")

    try:
        # 1. the split cases, the two-controller cohorts, the ensemble, then
        # the lineage run controller 1 dies in
        def oracle_a():
            t0 = time.perf_counter()
            out = {"split": spmd33_split(mesh.SINGLE, 8, dev, sz),
                   "cohorts": {c: spmd33_cohort(mesh.SINGLE, c, dev, sz, solo=True)
                               for c, v in SPMD33_COHORTS.items() if v[0] == 2},
                   "ensemble": spmd33_ensemble(mesh.SINGLE, dev, sz, solo=True)}
            out["s"] = time.perf_counter() - t0
            out["lineage"] = spmd33_lineage(mesh.SINGLE, 8, dev, sz, wd, "one")
            return out

        got, one = launch("serve", 2, oracle_a)
        check("r" not in got and "controller 1 exited with -9" in got.get("err", ""),
              f"spmd33 lineage: the killed launch ended otherwise: {got}")
        res = []
        for rank in range(2):
            with open(os.path.join(wd, f"serve33_{rank}.json")) as f:
                res.append(json.load(f))
        spmd33_split_check(res, one, device, card)

        def cohort_check(case, recs, want):
            spmd33_cohort_check(case, recs, want, device, card)

        for case, want in one["cohorts"].items():
            cohort_check(case, [{"rank": r["rank"], **r["cohorts"]} for r in res], want)
        for r in res:
            same("ensemble", r["ensemble"]["members"], one["ensemble"]["members"])
            check(not cuda or (set(r["ensemble"]["rec"]["launches"]) == {"flux_update_blocked"}
                               and not r["ensemble"]["rec"]["plain"]),
                  f"spmd33 ensemble: launches {r['ensemble']['rec']['launches']}")
            log(f"[spmd serve] deadline ensemble: {len(r['ensemble']['members'])} scenarios in "
                f"{r['ensemble']['cohorts']} cohort(s), controller {r['rank']}: "
                f"{r['ensemble']['rec']['ms']!r} ms a scenario-step, launches "
                f"{r['ensemble']['rec']['launches']}; one controller "
                f"{one['ensemble']['rec']['ms']!r} ms; every scenario bitwise equal to its "
                f"solo run on {card}")
        log(f"[spmd serve] 2 controllers: controller seconds {[r['s'] for r in res]!r}, "
            f"oracle {one['s']!r}")

        # 2. the plane cohort on 3 controllers x 1 slot
        got3, one3 = launch("plane", 3, lambda: spmd33_cohort(mesh.SINGLE, "plane", dev, sz,
                                                               solo=True))
        check("r" in got3, f"spmd33 plane: the controllers failed: {got3.get('err')}")
        cohort_check("plane", got3["r"], one3)

        # 3. the lineage relaunched, rescaled and finished
        got_l, _ = launch("resume", 2, lambda: None)
        check("r" in got_l, f"spmd33 lineage: the relaunch failed: {got_l.get('err')}")
        want = one["lineage"]
        L = SPMD33_LINEAGE
        for r in got_l["r"]:
            lin = r["lineage"]
            check(lin["gen"] == 2 and lin["step"] == 2 * L["every"],
                  f"spmd33 lineage: resumed generation {lin['gen']} at step {lin['step']}")
            check(lin["after"] == L["rescale_to"] and lin["dense_after"],
                  f"spmd33 lineage: rescaled to {lin['after']} slots")
            same("lineage", lin["density"], want["density"])
            check(lin["finite"], "spmd33 lineage: non-finite density")
            log(f"[spmd lineage] headline {sz['headline']} on 2 controllers x 4 slots: "
                f"controller 1 killed after its second commit, controller {r['rank']} "
                f"resumed generation {lin['gen']} at step {lin['step']} in "
                f"{lin['resume_s']!r} s, rescaled to 2 x 2 at step {L['rescale_at']} in "
                f"{lin['rescale_s']!r} s (commit {lin['rescale_commit_s']!r} s, re-landing "
                f"{lin['rescale_reland_s']!r} s), run({L['steps']}) bitwise equal to one "
                f"controller's uninterrupted run on 8 slots ({want['density']}) on {card}")
        with open(os.path.join(wd, "commit33_0.json")) as f:
            commit_s = json.load(f)
        check(len(commit_s) == 2, f"spmd33 lineage: controller 0 committed {commit_s}")
        log(f"[spmd lineage] commits of the killed run, controller 0: {commit_s!r} s "
            f"(a generation of {sz['headline']} f32 cells x 4 fields, rank 0 writes); the "
            f"lineage after the run: {sorted(os.listdir(os.path.join(wd, 'lineage33')))}")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[spmd serve] phase 33 seconds {secs!r} (budget {SPMD33_BUDGET_S!r}) on {card}")
    return one


#: what each dense case of phase 32 launches a controller: the kernel and
#: its launches for the run's steps (the plane case's step and run), B9 two
#: an exchange around the transport (pack and merge) on vlasov_amr, none on
#: the board (the torch dense loop)
def _dense_launches(case, steps):
    return {"headline": {"flux_update_blocked": steps}, "plane": {"flux_update": steps},
            "board": {}, "vlasov": {"vlasov_step": steps},
            "vlasov_amr": {"ring_copy": 2 * steps}}[case]


def _dense_ring_bytes(case, rec):
    """The ring bytes a controller sends in a dense case's run: two planes
    an exchange; the headline's density each step and vz once a run, the
    plane case's density and vz each step, the board's and Vlasov's one
    exchange a step (vlasov_amr's halo is not a plane ring)."""
    steps, plane = rec["steps"], rec["plane_bytes"]
    n = {"headline": steps + 1, "plane": 2 * steps, "board": steps,
         "vlasov": steps}.get(case)
    return None if n is None else 2 * n * plane


def spmd_dense_check(res, one, nproc, backend, device, card):
    """Phase 32's dense cases: every controller's slots hash as the
    oracle's on the same slots, each controller launched its kernel on
    every step of the run and no twin ran (on the card), its ring carried
    two planes an exchange; a line a controller with its launches, bytes a
    step and wall ms a step beside the oracle's."""
    for case, want in one.get("dense", {}).items():
        merged = {}
        for r in res:
            merged.update(r["dense"][case]["hashes"])
        check(merged == want["hashes"],
              f"spmd dense {case} {nproc} controllers {backend}: {merged} != one "
              f"controller {want['hashes']}")
        for r in res:
            rec = r["dense"][case]
            check(rec["finite"], f"spmd dense {case}: non-finite result")
            form = {"headline": lambda: rec["kind"][0] == "blocked_direct",
                    "plane": lambda: rec["kind"] == ["plane"],
                    "board": lambda: rec["dense"] and not rec["fused"],
                    "vlasov": lambda: rec["dense"] and rec["fused_block"] > 0,
                    "vlasov_amr": lambda: not rec["dense"]}[case]
            check(form(), f"spmd dense {case}: controller {r['rank']} took another form: "
                  f"{rec}")
            if device == "cuda":
                check(rec["launches"] == _dense_launches(case, rec["steps"])
                      and not rec["plain"],
                      f"spmd dense {case}: controller {r['rank']} launches "
                      f"{rec['launches']}, twins {rec['plain']}")
            ring = _dense_ring_bytes(case, rec)
            check(ring is None or rec["bytes"] == ring,
                  f"spmd dense {case}: controller {r['rank']} ring bytes {rec['bytes']} "
                  f"!= {ring}")
            check(ring is not None or rec["bytes"] > 0,
                  f"spmd dense {case}: controller {r['rank']} sent nothing")
            per = SPMD_DENSE_LAYOUT[case][1]
            log(f"[spmd dense] {case} {nproc} controllers x {per} slots ({backend}), "
                f"controller {r['rank']}: launches {rec['launches']} in "
                f"{rec['steps']} steps, transport bytes a step {rec['bytes'] / rec['steps']!r} "
                f"({rec['bytes']} in the run), wall ms a step {rec['ms']!r}; one "
                f"controller x {nproc * per} slots: launches {want['launches']}, wall ms a "
                f"step {want['ms']!r}; {'dense kind ' + str(rec['kind']) if 'kind' in rec else ''}"
                f" bitwise equal on {card}")


#: phase 32's models: the form each engages (``operator_space``,
#: ``_flat_kind``, the re-bucket) and what it launches a controller in its
#: timed part: B9 two an exchange around the transport (pack and merge) for
#: the rolled operator (one ghost refresh an apply: the initial residual's
#: and two an iteration) and the particles (counts and coordinates each
#: step), nothing for the forms that ride the ring (B8 and B5 / B6 are one-
#: slot kernels)
SPMD_MODEL_FORMS = {"poisson": "flat", "poisson_rolled": "rolled",
                    "pic_refined_lb": "device", "sharded": "sharded",
                    "boxed": "sharded", "ml": "ml"}


def _model_launches(case, steps):
    return {"poisson_rolled": {"ring_copy": 2 * (2 * steps + 1)},
            "pic_refined_lb": {"ring_copy": 4 * steps}}.get(case, {})


def spmd_models_check(res, one, nproc, backend, device, card):
    """Phase 32's models: every controller's result (by cell id) bitwise
    equal to the oracle's on the same slots, the form that engaged, the
    launches a controller and no twin (on the card), bytes sent; a line a
    controller with its wall ms a step and bytes beside the oracle's."""
    for case, want in one["models"].items():
        for r in res:
            rec = r["models"][case]
            check(rec["hashes"] == want["hashes"],
                  f"spmd {case} {nproc} controllers {backend}: controller {r['rank']} "
                  f"{rec['hashes']} != one controller {want['hashes']}")
            check(rec["finite"], f"spmd {case}: non-finite result")
            check(rec["form"] == want["form"] == SPMD_MODEL_FORMS[case]
                  and not rec.get("prefer_boxed"),
                  f"spmd {case}: controller {r['rank']} took {rec['form']} "
                  f"(one controller {want['form']})")
            if device == "cuda":
                check(rec["launches"] == _model_launches(case, rec["steps"])
                      and not rec["plain"],
                      f"spmd {case}: controller {r['rank']} launches {rec['launches']}, "
                      f"twins {rec['plain']}")
            check(rec["bytes"] > 0, f"spmd {case}: controller {r['rank']} sent nothing")
            unit = "iteration" if case.startswith("poisson") else "step"
            log(f"[spmd models] {case} ({rec['form']}, {rec['n_leaves']} leaves) {nproc} "
                f"controllers x {r['n_devices'] // nproc} slots ({backend}), controller "
                f"{r['rank']}: launches {rec['launches']} in "
                f"{rec['steps']} {unit}s, bytes a {unit} {rec['bytes'] / rec['steps']!r} "
                f"({rec['bytes']} in all), wall ms a {unit} {rec['ms']!r}; one controller: "
                f"launches {want['launches']}, wall ms a {unit} {want['ms']!r}; "
                f"{want['hashes']} bitwise equal on {card}")


#: phase 33's sizes: the bench's widths ("full"; the split phases' grids of
#: phases 17, 18 and 19: the refined 48^3 grid, 198,008 leaves, f32; the
#: refined 16^3 grid, 7,456 leaves x 512 bins; the 500x500 board; the
#: cohorts' headline 128x128x64 and plane 128x128x63 f32 and Vlasov 32^3 x
#: 8^3; the wide sweep's 6^3 at neighbourhood length 2) and "small" ones for
#: the CPU rehearsal.  Steps are cut (phase 17: 200 split steps; phase 30:
#: the same run(300)), never widths
SPMD33 = {
    "full": {"refined": 48, "vl": (16, 8), "board": RES_BOARD, "headline": RES_HEADLINE,
             "plane": (128, 128, 63), "vlasov": ((32, 32, 32), 8), "wide": 6},
    "small": {"refined": 12, "vl": (8, 2), "board": 60, "headline": (16, 16, 16),
              "plane": (16, 16, 15), "vlasov": ((8, 8, 16), 2), "wide": 6},
}
#: the split cases' steps (turns), each beside as many blocking gather steps
SPMD33_SPLIT_STEPS = {"advection": 20, "vlasov": 10, "gol": 50}
#: the cohorts: (controllers, slots a controller, members W, steps, k)
SPMD33_COHORTS = {"dense": (2, 4, 4, 32, 16), "plane": (3, 1, 4, 10, 10),
                  "vlasov": (2, 4, 4, 10, 10), "split": (2, 4, 4, 10, 4),
                  "wide": (2, 1, 16, 16, 4)}
#: the deadline ensemble: scenarios, their steps (from a seed) and slots
SPMD33_ENSEMBLE = (8, (8, 24), 8)
#: the lineage: the run, a commit every so many steps, the rescale's step
#: and slot count (2 controllers x 4 slots -> 2 x 2)
SPMD33_LINEAGE = {"steps": RES_STEPS, "every": 100, "rescale_at": 250, "rescale_to": 4}
#: the phase's budget, process start-ups included (logged beside its time)
SPMD33_BUDGET_S = 90.0


def _h(a):
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def spmd_drive(device, fn, steps, counter=lambda: 0):
    """``fn()`` with the launch counts at 0, between two barriers and card
    synchronisations: (its value, a record of the launches, twin calls,
    bytes ``counter()`` grew by and wall ms a step)."""
    import torch

    from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
    from dccrg_tpu_torch.utils.collectives import barrier

    def sync():
        barrier("spmd.drive")
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    reset_counts()
    b0 = counter()
    t = time.perf_counter()
    out = fn()
    sync()
    secs = time.perf_counter() - t
    return out, {"launches": {k: v for k, v in LAUNCHES.items() if v},
                 "plain": sum(PLAIN_CALLS.values()), "steps": steps,
                 "bytes": counter() - b0, "ms": secs / steps * 1e3}


def spmd33_grid(ctl, D, device, n, radii=(), center=(0.5, 0.5, 0.5), hood=0, lb="RCB",
                length=None):
    """An n^3 periodic grid (``length``: another shape) of D slots over
    ``ctl``, each ball of ``radii`` around ``center`` refined once more."""
    import numpy as np

    from dccrg_tpu_torch import CartesianGeometry, Grid

    length = length or (n, n, n)
    g = (Grid().set_initial_length(length).set_neighborhood_length(hood)
         .set_periodic(True, True, True).set_maximum_refinement_level(len(radii))
         .set_load_balancing_method(lb)
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / m for m in length))
         .initialize(n_devices=D, device=device, controllers=ctl))
    for rad in radii:
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - np.asarray(center), axis=1)
        lv = g.mapping.get_refinement_level(ids)
        g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
        g.stop_refining()
    return g


def spmd33_split(ctl, D, device, sz, put_timing=False) -> dict:
    """Phase 33's split cases (D6) on the controllers ``ctl`` (``mesh.SINGLE``:
    the oracle on the same D slots): the split-phase step of Advection (the
    refined 48^3 grid, f32), Vlasov (the refined 16^3 grid, 512 bins, f32)
    and Game of Life (the 500x500 board), each run beside as many blocking
    gather steps, with the counts at 0 around each.  Returns, a case: the
    hashes of the split run's fields by cell id (equal to the blocking
    run's, checked here), and a record of the split and the blocking run;
    with ``put_timing`` under the ipc transport on the card, B9's
    remote-write timing at the advection and Vlasov payloads
    (:func:`ipc_put_timing`)."""
    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, GameOfLife, Grid, Vlasov

    out = {}
    for case, steps in SPMD33_SPLIT_STEPS.items():
        if case == "advection":
            g = spmd33_grid(ctl, D, device, sz["refined"], (0.3,), (0.3, 0.5, 0.5))
            eager = Advection(g, dtype=np.float32, allow_dense=False, use_kernels=False)
            split = Advection(g, dtype=np.float32, overlap=True)
            s = split.initialize_state()
            args = (0.4 * split.max_time_step(s),)
            fields = ("density",)
        elif case == "vlasov":
            n, nv = sz["vl"]
            g = spmd33_grid(ctl, D, device, n, (0.3,))
            eager = Vlasov(g, nv=nv, dtype=np.float32)
            split = Vlasov(g, nv=nv, dtype=np.float32, overlap=True)
            s = split.initialize_state()
            args = (float(np.float32(0.4 * split.max_time_step())),)
            fields = ("f",)
        else:
            n = sz["board"]
            g = (Grid().set_initial_length((n, n, 1)).set_neighborhood_length(1)
                 .initialize(n_devices=D, device=device, controllers=ctl))
            cells = g.get_cells()
            eager, split = GameOfLife(g, allow_dense=False), GameOfLife(g, overlap=True)
            s = eager.new_state(alive_cells=cells[np.random.default_rng(0).random(len(cells))
                                                  < 0.3])
            args = ()
            fields = ("is_alive", "live_neighbor_count")
        ex = g.halo()
        bytes_ = lambda: ex.transport_bytes
        sb, rec_b = spmd_drive(device, lambda: eager.run(s, steps, *args), steps, bytes_)
        sf, rec_s = spmd_drive(device, lambda: split.run(s, steps, *args), steps, bytes_)
        for f in fields:
            check(torch.equal(sb[f], sf[f]), f"spmd33 split {case}: the split run != the "
                  f"blocking run ({f})")
        ids = g.get_cells()
        vals = {f: g.get_cell_data(sf, f, ids) for f in fields}
        out[case] = {"hashes": {f: _h(v) for f, v in vals.items()},
                     "n_leaves": int(len(ids)), "split": rec_s, "blocking": rec_b,
                     "finite": bool(all(np.isfinite(v.astype(np.float64)).all()
                                        for v in vals.values()))}
        if (put_timing and ctl.backend == "ipc" and case in ("advection", "vlasov")
                and torch.device(device).type == "cuda"):
            out[case]["put"] = ipc_put_timing(ctl, ex, {f: sf[f] for f in fields})
        del g, eager, split, s, sb, sf
    return out


def _cohort_states(model, s0, W, field):
    """W members: ``s0`` with ``field`` scaled by 1 + 0.05 w."""
    out = []
    for w in range(W):
        s = {k: v.clone() for k, v in s0.items()}
        s[field] = s[field] * (1.0 + 0.05 * w)
        out.append(s)
    return out


def spmd33_cohort(ctl, case, device, sz, solo=False) -> dict:
    """One of phase 33's cohorts (SPMD33_COHORTS) on the controllers ``ctl``
    (``mesh.SINGLE``: the oracle on the same slots, which with ``solo``
    also runs every member alone and holds it bitwise against the cohort):
    W members admitted into one cohort, ``Cohort.step(k)`` until every
    member is done, the counts at 0 around the steps.  Returns the members'
    hashes (every slot, or by cell id for the row layouts), the record of
    the steps and the form."""
    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, GameOfLife, Vlasov
    from dccrg_tpu_torch.serve import Scenario, Scheduler
    from dccrg_tpu_torch.utils.collectives import fetch

    nproc, per, W, steps, k = SPMD33_COHORTS[case]
    D = nproc * per
    dt = None
    if case in ("dense", "plane"):
        g = spmd33_grid(ctl, D, device, 0, length=sz["headline" if case == "dense" else "plane"])
        model = Advection(g, dtype=np.float32)
        s0 = model.initialize_state()
        dt = 0.4 * model.max_time_step(s0)
        states, fields = _cohort_states(model, s0, W, "density"), ("density",)
        counter, form = (lambda: model._extend.transport_bytes), list(model.dense_kind)
    elif case == "vlasov":
        length, nv = sz["vlasov"]
        g = spmd33_grid(ctl, D, device, 0, length=length)
        model = Vlasov(g, nv=nv, dtype=np.float32)
        s0 = model.initialize_state()
        dt = float(np.float32(0.4 * model.max_time_step()))
        states, fields = _cohort_states(model, s0, W, "f"), ("f",)
        counter, form = (lambda: model._extend.transport_bytes), model._fused_block
    elif case == "split":
        g = spmd33_grid(ctl, D, device, sz["refined"], (0.3,), (0.3, 0.5, 0.5))
        model = Advection(g, dtype=np.float32, overlap=True)
        s0 = model.initialize_state()
        dt = 0.4 * model.max_time_step(s0)
        states, fields = _cohort_states(model, s0, W, "density"), ("density",)
        counter, form = (lambda: g.halo().transport_bytes), "split"
    else:
        moore = [(i, j, m) for i in (-1, 0, 1) for j in (-1, 0, 1) for m in (-1, 0, 1)
                 if (i, j, m) != (0, 0, 0)]
        g = spmd33_grid(ctl, D, device, sz["wide"], hood=2)
        g.add_neighborhood(7, moore)
        model = GameOfLife(g, hood_id=7, allow_dense=False)
        cells = g.get_cells()
        states = [model.new_state(alive_cells=cells[np.random.default_rng(w).random(len(cells))
                                                    < 0.3]) for w in range(W)]
        fields = ("is_alive", "live_neighbor_count")
        counter, form = (lambda: g.halo().transport_bytes), "wide"
    sched = Scheduler(verify=False, steps_per_dispatch=k)
    tickets = [sched.submit(Scenario(model, s, steps, dt=dt)) for s in states]
    sched.admit()
    check(len(sched.cohorts) == 1, f"spmd33 cohort {case}: {len(sched.cohorts)} cohorts")
    cohort = next(iter(sched.cohorts.values()))
    if case == "wide":
        check(cohort._wide is not None, "spmd33 cohort wide: the wide body did not engage")

    def serve():
        while cohort.active_mask().any():
            cohort.step(k)
        return [cohort.retire(int(slot)) for slot in cohort.finished_slots()]

    _, rec = spmd_drive(device, serve, steps, counter)

    def digest(res):
        if case in ("split", "wide"):
            ids = g.get_cells()
            return {f: _h(g.get_cell_data(res, f, ids)) for f in fields}
        return {f: _h(fetch(res[f])) for f in fields}

    members = [digest(t.result) for t in tickets]
    if solo:
        for t, s, dig in zip(tickets, states, members):
            for _ in range(steps):
                s = model.step(s) if dt is None else model.step(s, dt)
            check(digest(s) == dig, f"spmd33 cohort {case}: a member != its solo run")
    finite = all(bool(torch.isfinite(t.result[f].to(torch.float32)).all())
                 for t in tickets for f in fields)
    return {"members": members, "form": form, "W": W, "k": k, "rec": rec,
            "finite": finite, "kind": cohort.spec.kind, "g": cohort._wide_g(k)}


def spmd33_ensemble(ctl, device, sz, solo=False) -> dict:
    """Phase 33's deadline ensemble: SPMD33_ENSEMBLE's seeded headline
    scenarios (density scaled, dt and steps from a seed), each with a
    deadline read off this process's clock (controller 0's rule the
    ticks), policy ``deadline``; each retires, hashed (every slot) and,
    with ``solo``, held bitwise against its solo run."""
    import numpy as np

    from dccrg_tpu_torch import Advection
    from dccrg_tpu_torch.serve import Ensemble
    from dccrg_tpu_torch.utils.collectives import fetch

    n, (lo, hi), D = SPMD33_ENSEMBLE
    g = spmd33_grid(ctl, D, device, 0, length=sz["headline"])
    model = Advection(g, dtype=np.float32)
    s0 = model.initialize_state()
    dt0 = 0.4 * model.max_time_step(s0)
    rng = np.random.default_rng(33)
    ens = Ensemble(policy="deadline", verify=False)
    now = time.perf_counter()
    runs = []
    for i in range(n):
        s = {k: v.clone() for k, v in s0.items()}
        s["density"] = s["density"] * float(1.0 + rng.random())
        steps, dt = int(rng.integers(lo, hi + 1)), dt0 * float(0.5 + 0.5 * rng.random())
        t = ens.submit(model, s, steps=steps, dt=dt, tenant=f"t{i % 3}",
                       deadline=now + float(rng.uniform(0.05, 3.0)))
        runs.append((s, steps, dt, t))
    _, rec = spmd_drive(device, ens.run, sum(r[1] for r in runs))
    members = []
    for s, steps, dt, t in runs:
        check(t.status == "done", f"spmd33 ensemble: a scenario is {t.status}")
        members.append(_h(fetch(t.result["density"])))
        if solo:
            for _ in range(steps):
                s = model.step(s, dt)
            check(_h(fetch(s["density"])) == members[-1],
                  "spmd33 ensemble: a scenario != its solo run")
    return {"members": members, "cohorts": len(ens.cohorts), "rec": rec}


def spmd33_lineage(ctl, D, device, sz, wd, phase) -> dict:
    """Phase 33's lineage on the headline (BLOCK): ``kill`` runs from the
    start with a commit every SPMD33_LINEAGE["every"] steps, controller 1
    armed to die right after its second commit (``sigkill.post_commit:1:0:
    1:1``); ``resume`` lands the newest valid generation on D slots, runs
    to the rescale's step, rescales to its slot count and finishes; ``one``
    (the oracle) runs uninterrupted.  Returns the density by cell id, the
    generation and step resumed from, the commit and rescale seconds."""
    import numpy as np

    from dccrg_tpu_torch import Advection
    from dccrg_tpu_torch.resilience import CheckpointLineage, rescale
    from dccrg_tpu_torch.resilience.inject import plane

    L = SPMD33_LINEAGE
    lin = CheckpointLineage(os.path.join(wd, "lineage33"), keep=3)
    out = {"commit_s": [], "gen": None, "step": 0}
    if phase == "resume":
        t = time.perf_counter()
        g, rows, hdr, gen = lin.latest_valid(headline_spec(), n_devices=D, device=device,
                                             load_balancing_method="BLOCK")
        adv, s = land_headline(g, rows)
        out.update(gen=gen, step=int(hdr.decode()), resume_s=time.perf_counter() - t)
        check(adv.dense is not None, "spmd33 lineage: the landed grid is not dense")
    else:
        g = spmd33_grid(ctl, D, device, 0, lb="BLOCK", length=sz["headline"])
        adv = Advection(g, dtype=np.float32)
        s = adv.initialize_state()
        if phase == "kill" and ctl.rank == 1:
            plane.arm("sigkill.post_commit", prob=1.0, seed=0, count=1, after=1)
    # the velocities never change, so every run's dt is the same
    dt = 0.4 * adv.max_time_step(s)
    step = out["step"]
    while step < L["steps"]:
        if phase == "resume" and step == L["rescale_at"]:
            t = time.perf_counter()
            r = rescale(g, adv._dense_to_rows(s), headline_spec(), L["rescale_to"],
                        lineage=lin)
            g = r.grid
            adv, s = land_headline(g, r.state)
            out.update(rescale_s=time.perf_counter() - t, rescale_commit_s=r.commit_s,
                       rescale_reland_s=r.reland_s, after=r.n_devices_after,
                       dense_after=adv.dense is not None)
        nxt = L["rescale_at"] if phase == "resume" and step < L["rescale_at"] else \
            (step // L["every"] + 1) * L["every"]
        nxt = min(nxt, L["steps"])
        s = adv.run(s, nxt - step, dt)
        step = nxt
        if phase == "kill" and step % L["every"] == 0:
            t = time.perf_counter()
            lin.commit(g, adv._dense_to_rows(s), headline_spec(),
                       user_header=str(step).encode())
            out["commit_s"].append(time.perf_counter() - t)
            _write_json(os.path.join(wd, f"commit33_{ctl.rank}.json"), out["commit_s"])
    ids = g.get_cells()
    rho = adv.get_cell_data(s, "density", ids)
    out.update(density=_h(rho), finite=bool(np.isfinite(rho).all()), n_devices=g.n_devices)
    return out


def resilience_phase(dev, card, drive, refined):
    """Phase 30: a crash, a resume and rescales of the headline, the board
    rescaled 1 -> 8 -> 1, a supervised hang, a NaN storm on ``refined``
    (phase 17's grid, state, spec) and a torn generation, all on ``dev``.
    ``drive`` runs a path with the launch counts at 0 and checks them;
    ``card`` names the device in every timing line.  Any failure raises."""
    import shutil
    import signal

    import numpy as np
    import torch

    from dccrg_tpu_torch import GameOfLife, obs
    from dccrg_tpu_torch.io.checkpoint import CheckpointError
    from dccrg_tpu_torch.resilience import CheckpointLineage, plane, rescale
    from dccrg_tpu_torch.resilience.soak import check_flightrec_dump, supervise
    from dccrg_tpu_torch.utils.verify import verify_finite, verify_grid

    headline, board, seg_steps = RES_HEADLINE, RES_BOARD, RES_SEG_STEPS
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dccrg_resilience_")
    spec = headline_spec()
    shape_s = "x".join(map(str, headline))
    timings = []
    children = []    # every child started, killed on the way out if still running

    def child(args, env_extra=None):
        p, log_f = launch_child(wd, args, env_extra)
        children.append(p)
        return p, log_f

    def counter(name, **labels):
        return obs.metrics.counter_value(name, **labels)

    def lineage_bytes(d):
        """(the newest generation's bytes, every kept generation's)."""
        sizes = [int(e["bytes"]) for e in CheckpointLineage(d).generations()]
        return sizes[-1], sum(sizes)

    try:
        # --- crash -> resume on 8 slots -> rescale to 1, the headline
        g, adv, s0, dt = headline_model(headline, dev)
        check(adv.fused, f"resilience headline: not fused ({adv.dense_kind})")
        total = RES_STEPS
        ref = drive("resilience headline reference",
                    lambda: adv.run(s0, total, dt), {"fused_run": 1})
        wd = os.path.join(root, "headline")
        os.makedirs(wd)
        t = time.perf_counter()
        p, log_f = child(["headline", wd, dev.type],
                         {"DCCRG_FAULT": "sigkill.post_commit:1:0:1:1"})
        rc = p.wait(timeout=600)
        log_f.close()
        child_s = time.perf_counter() - t
        check(rc == -signal.SIGKILL,
              f"resilience: the crash child exited {rc}, not by SIGKILL:\n{child_log(wd)}")
        check("HEADLINE_CHILD_DONE" not in child_log(wd), "resilience: the child finished")
        probs = check_flightrec_dump(wd, "resilience headline child")
        check(not probs, f"resilience: {probs}")
        dumps = [f for f in os.listdir(wd) if f.startswith("flightrec_")]
        with open(os.path.join(wd, dumps[0])) as f:
            in_flight = sorted(u["id"] for u in json.load(f)["in_flight"])
        check(in_flight == [f"headline/{seg_steps}"],
              f"resilience: the postmortem names {in_flight}, not headline/{seg_steps}")
        with open(os.path.join(wd, "report.json")) as f:
            child_rep = json.load(f)
        check(child_rep["recompiles"] == 0,
              f"resilience: the fresh child compiled {child_rep['recompiles']} libraries")
        log(f"[resilience] crash child: exit {rc} (SIGKILL) after its second commit, "
            f"{child_s!r} s wall; postmortem {dumps[0]} valid, in flight {in_flight}; "
            f"its report: epoch.recompiles {child_rep['recompiles']}, launches "
            f"{child_rep['launches']}, libraries {child_rep['libraries']}")
        lin_dir = os.path.join(wd, "lineage")
        # the scan and load under BLOCK (the z-slabs a dense model needs on
        # 8 slots), then the invariant oracle Grid.resume_latest runs, timed
        # apart
        t = time.perf_counter()
        g8, rows8, hdr, gen = CheckpointLineage(lin_dir).latest_valid(
            spec, n_devices=8, device=dev, load_balancing_method="BLOCK", verify=False)
        load_s = time.perf_counter() - t
        verify_grid(g8)
        verify_s = time.perf_counter() - t - load_s
        check((gen, int(hdr)) == (2, 2 * seg_steps),
              f"resilience: resumed generation {gen} at step {hdr!r}, not 2 at "
              f"{2 * seg_steps}")
        check(g8.device.type == dev.type, f"resilience: resumed onto {g8.device}")
        adv8, s8 = land_headline(g8, rows8)
        check(adv8.dense is not None and not adv8.fused,
              f"resilience: 8-slot dispatch {getattr(adv8, 'dense_kind', None)}")
        kname = {"blocked_direct": "flux_update_blocked",
                 "plane": "flux_update"}[adv8.dense_kind[0]]
        out8 = drive("resilience headline 8 slots",
                     lambda: adv8.run(s8, 2 * seg_steps, dt), {kname: 2 * seg_steps})
        t = time.perf_counter()
        r = rescale(g8, adv8._dense_to_rows(out8), spec, 1, directory=lin_dir)
        timings.append(("headline 8 -> 1", r.commit_s, r.reland_s, lineage_bytes(lin_dir)))
        check(r.grid.device.type == dev.type and r.n_devices_after == 1
              and r.generation == 3, f"resilience: rescale landed {r.grid.device} "
              f"{r.n_devices_after} slots, generation {r.generation}")
        adv1, s1 = land_headline(r.grid, r.state)
        check(adv1.fused, "resilience: the 1-slot re-landing is not fused")
        out1 = drive("resilience headline 1 slot",
                     lambda: adv1.run(s1, total - 4 * seg_steps, dt), {"fused_run": 1})
        diff = int((out1["density"] != ref["density"]).sum())
        check(diff == 0, f"resilience: 1 -> 8 -> 1 headline differs from the "
              f"uninterrupted run in {diff} cells (max |d| "
              f"{float((out1['density'] - ref['density']).abs().max())!r})")
        log(f"[resilience] headline {shape_s}: resumed generation {gen} at step {hdr.decode()} "
            f"on 8 slots ({adv8.dense_kind}, {kname}): scan + load {load_s!r} s, "
            f"verify_grid {verify_s!r} s; "
            f"{2 * seg_steps} steps, rescaled to 1 slot (generation {r.generation}), "
            f"{total - 4 * seg_steps} steps through fused_run: density bitwise equal to "
            f"the uninterrupted run({total}) (-0 == +0)")

        # --- a torn generation on the headline lineage
        lineage = CheckpointLineage(lin_dir, keep=3)
        rej0 = sum(obs.metrics.report()["counters"].get("lineage.commit_rejected", {}).values())
        plane.arm("checkpoint.torn_write", prob=1.0, seed=3, count=1)
        try:
            lineage.commit(r.grid, r.state, spec, user_header=b"torn")
            check(False, "resilience: a torn commit was accepted")
        except CheckpointError as err:
            check(err.section == "lineage", f"resilience: torn commit raised {err}")
        finally:
            plane.disarm("checkpoint.torn_write")
        rej = sum(obs.metrics.report()["counters"].get("lineage.commit_rejected", {}).values())
        # the scan alone is under test: generation 3 was verified by rescale
        _g, _s, thdr, tgen = lineage.latest_valid(spec, n_devices=1, device=dev,
                                                  verify=False)
        check(rej == rej0 + 1 and tgen == 3,
              f"resilience: torn commit: commit_rejected {rej0} -> {rej}, resumed "
              f"generation {tgen}")
        log(f"[resilience] torn generation: commit raised CheckpointError(lineage), "
            f"lineage.commit_rejected +1, latest_valid returned generation {tgen}")
        del _g, _s, g, adv, s0, ref, g8, rows8, adv8, s8, out8, r, adv1, s1, out1

        # --- the board rescaled 1 -> 8 -> 1 against one-slot B4
        gb, alive0 = gol_board(board, 1, dev)
        gol = GameOfLife(gb)
        check(gol.fused, "resilience gol: no whole-run kernel")
        sb = gol.new_state(alive_cells=alive0)
        want = set(gol.alive_cells(drive("resilience gol reference",
                                         lambda: gol.run(sb, RES_STEPS),
                                         {"gol_run": 1})).tolist())
        gd = os.path.join(root, "gol_rescale")
        s, gcur, model = sb, gb, gol
        for turns_done, target in ((100, 8), (200, 1)):
            s = drive(f"resilience gol {gcur.n_devices} slot(s)",
                      lambda: model.run(s, 100),
                      {"gol_run": 1} if gcur.n_devices == 1 else {"ring_copy": 100})
            r = rescale(gcur, s, GameOfLife.SPEC, target, directory=gd,
                        user_header=str(turns_done).encode())
            check(r.grid.device.type == dev.type and r.n_devices_after == target,
                  f"resilience gol: rescale landed {r.grid.device}, {r.n_devices_after}")
            timings.append((f"gol {gcur.n_devices} -> {target}", r.commit_s, r.reland_s,
                            lineage_bytes(gd)))
            s, gcur, model = r.state, r.grid, GameOfLife(r.grid)
        s = drive("resilience gol 1 slot, after", lambda: model.run(s, 100), {"gol_run": 1})
        got = set(model.alive_cells(s).tolist())
        check(got == want, f"resilience gol: {len(got)} alive after 1 -> 8 -> 1, the "
              f"one-slot run {len(want)}")
        log(f"[resilience] gol {board}x{board}: {RES_STEPS} turns rescaled 1 -> 8 -> 1 after "
            f"turns 100 and 200: alive set ({len(got)} cells) equal to the one-slot "
            f"gol_run run({RES_STEPS})")

        # --- a supervised hang on 8 slots, restarted on 4 from latest_valid
        wd = os.path.join(root, "supervised")
        os.makedirs(wd)
        for attempt, nd in enumerate((8, 4)):
            hb = os.path.join(wd, f"heartbeat_{attempt}.jsonl")
            env = {"DCCRG_FAULT": "step.hang:1:0:1:60"} if attempt == 0 else {}
            t = time.perf_counter()
            p, log_f = child(["gol", wd, dev.type, nd, hb], env)
            esc0 = counter("supervisor.escalations", action="rescale_down")
            warn0 = counter("supervisor.warnings", reason="no-progress")
            outcome, rc, actions = supervise(p, hb, RES_STALL_AFTER_S, timeout=300.0)
            log_f.close()
            if attempt == 0:
                check(outcome == "rescale_down"
                      and [a[:2] for a in actions] == [("warn", "no-progress"),
                                                       ("rescale_down", "no-progress")],
                      f"resilience supervised: {outcome}, ladder {actions}:\n{child_log(wd)}")
                with open(hb) as f:
                    beats = [json.loads(ln) for ln in f if ln.endswith("\n")]
                hang_ts = max(b["ts"] for b in beats if b.get("step") == 60)
                probs = check_flightrec_dump(wd, "resilience supervised child")
                check(not probs, f"resilience: {probs}")
                log(f"[resilience] supervised: the hang after turn 60 on 8 slots detected as "
                    f"no-progress: warn {actions[0][2] - hang_ts!r} s and rescale_down "
                    f"{actions[1][2] - hang_ts!r} s after the last beat of turn 60 "
                    f"(stall window {RES_STALL_AFTER_S} s); ladder counters supervisor.warnings"
                    f"{{reason=no-progress}} +{counter('supervisor.warnings', reason='no-progress') - warn0}, "
                    f"supervisor.escalations{{action=rescale_down}} "
                    f"+{counter('supervisor.escalations', action='rescale_down') - esc0}; "
                    f"child killed after {time.perf_counter() - t!r} s")
            else:
                check((outcome, rc) == ("exited", 0) and not actions,
                      f"resilience supervised restart: {outcome} {rc}, {actions}:\n"
                      f"{child_log(wd)}")
        with open(os.path.join(wd, "report.json")) as f:
            rep = json.load(f)
        got = set(np.load(os.path.join(wd, "alive.npy")).tolist())
        check(rep["resumed_at"] == 50 and got == want,
              f"resilience supervised: resumed at {rep['resumed_at']}, {len(got)} alive vs "
              f"{len(want)}")
        log(f"[resilience] supervised: relaunched on 4 slots from latest_valid (turn "
            f"{rep['resumed_at']}), finished turn {RES_STEPS} with the one-slot alive set; its report: "
            f"epoch.recompiles {rep['recompiles']}, launches {rep['launches']}")

        # --- a NaN storm through one blocking exchange of the refined grid
        g_r, s_r, spec_r = refined
        before = {k: v.clone() for k, v in s_r.items()}
        inj0 = counter("resilience.injected", site="halo.nan")
        rows0 = counter("resilience.nan_rows_poisoned")
        plane.arm("halo.nan", prob=1.0, seed=0, count=1)
        try:
            stormed = drive("resilience nan storm",
                            lambda: g_r.update_copies_of_remote_neighbors(s_r),
                            {"ring_copy": 1})
        finally:
            plane.disarm("halo.nan")
        caught = None
        try:
            verify_finite(g_r, stormed, spec_r)
        except AssertionError as err:
            caught = str(err)
        check(caught is not None, "resilience: verify_finite passed a stormed state")
        check(counter("resilience.injected", site="halo.nan") == inj0 + 1,
              "resilience: resilience.injected{site=halo.nan} did not rise by 1")
        clean = drive("resilience nan storm, disarmed",
                      lambda: g_r.update_copies_of_remote_neighbors(s_r), {"ring_copy": 1})
        verify_finite(g_r, clean, spec_r)
        check(all(torch.equal(v, before[k]) for k, v in s_r.items()),
              "resilience: the storm changed its input state")
        log(f"[resilience] nan storm on {len(g_r.get_cells())} leaves, "
            f"{g_r.n_devices} slots: {counter('resilience.nan_rows_poisoned') - rows0} rows "
            f"poisoned; verify_finite raised ({caught[:80]}...); the next exchange clean; "
            f"the input unchanged")
        del stormed, clean, before
        for label, commit_s, reland_s, (newest, kept) in timings:
            log(f"[resilience] rescale {label}: commit_s {commit_s!r}, reland_s {reland_s!r} "
                f"(verify_grid included), generation bytes {newest}, lineage bytes {kept} "
                f"on {card}")
        log(f"[resilience] phase seconds {time.perf_counter() - t_phase!r} on {card}")
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- 31. serve

#: phase 31's sizes: the bench's widths (bench.py's headline, its Vlasov,
#: microbench.py's ensemble and wide-halo sweeps); steps are what the
#: phase's time allows
SERVE_DENSE_WIDTHS = (1, 4, 16)
SERVE_DENSE_K, SERVE_DENSE_STEPS = 16, 64
SERVE_PLANE_W, SERVE_PLANE_STEPS = 4, 10
SERVE_VLASOV_W, SERVE_VLASOV_K, SERVE_VLASOV_STEPS = 4, 10, 20
SERVE_SPLIT_W, SERVE_SPLIT_K, SERVE_SPLIT_STEPS = 4, 4, 20
SERVE_SWEEP_SIZES, SERVE_SWEEP_KS, SERVE_SWEEP_STEPS = (1, 64, 256), (1, 4, 16), 16
SERVE_WIDE_B, SERVE_WIDE_GS, SERVE_WIDE_KS, SERVE_WIDE_STEPS = 16, (2, 4), (4, 16), 16
SERVE_FLEET_SPECS = 24


def serve_phase(dev, card, drive, g_sa, s_sa, adv_s, event_ms, bound):
    """Phase 31: the serving tier on the card.  Returns the member-axis
    timing rows (B2, B3, B7) for the log."""
    import numpy as np
    import torch

    from dccrg_tpu_torch import CartesianGeometry, GameOfLife, Grid, Vlasov, obs
    from dccrg_tpu_torch.ops import dense_advection as K
    from dccrg_tpu_torch.ops import vlasov_kernel as V
    from dccrg_tpu_torch.parallel import halo as H
    from dccrg_tpu_torch.resilience.soak import (AB_DL_DEADLINE_S, AB_ROUND_DEADLINES,
                                                 run_fleet)
    from dccrg_tpu_torch.serve import Scenario, Scheduler

    t_phase = time.perf_counter()

    def sync():
        torch.cuda.synchronize()

    def bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    def owned(x, local):
        """``x``'s owned rows (CUDA has no boolean indexing of uint32:
        the same bits as int32)."""
        return (x.view(torch.int32) if x.dtype == torch.uint32 else x)[local]

    def counter(name):
        return sum(obs.metrics.report()["counters"].get(name, {}).values())

    def serve(sched, label, expect):
        """Admit, then step every cohort to the end under ``drive``; the
        member-steps a second."""
        sched.admit()
        served = {}

        def go():
            t = time.perf_counter()
            n = 0
            while True:
                s = sched.step_once()
                if s == 0:
                    break
                n += s
            sync()
            served.update(n=n, s=time.perf_counter() - t)
        drive(label, go, expect)
        return served["n"], served["s"]

    def solo(model, state, steps, dt):
        for _ in range(steps):
            state = model.step(state, dt) if dt is not None else model.step(state)
        return state

    rows = []

    def member_row(name, shape, fn, plain, b):
        """Time the member-axis launch ``fn`` beside its twin ``plain`` (on
        the same inputs on the card) and hold the two bitwise."""
        check(bits(fn(), plain()), f"serve {name} member axis {shape}: != its twin")
        ms, plain_ms = event_ms(fn, 20), event_ms(plain, 3)
        rows.append((name, shape, ms, b))
        log(f"[serve] {name} member axis at {shape}: {ms!r} ms (twin {plain_ms!r} ms, "
            f"bitwise equal), bound {b[0]!r} ms ({b[1]}; W x one member's), kernel/bound "
            f"{ms / b[0]!r} on {card}")

    # 1. dense advection cohorts on the headline grid (B2 with a member axis)
    _, adv_h, s_h, dt_h = headline_model((128, 128, 64), dev)
    check(adv_h.dense_kind[0] == "blocked_direct", f"serve dense: {adv_h.dense_kind}")
    mts = adv_h.max_time_step(s_h)
    rng = np.random.default_rng(31)
    for W in SERVE_DENSE_WIDTHS:
        members = []
        for w in range(W):
            rho = torch.tensor(rng.uniform(0.1, 1.0, (1, 64, 128, 128)).astype(np.float32),
                               device=dev)
            members.append(({**s_h, "density": rho}, mts * (0.3 + 0.02 * w)))
        sched = Scheduler(steps_per_dispatch=SERVE_DENSE_K)
        tickets = [sched.submit(Scenario(adv_h, s, SERVE_DENSE_STEPS, dt=dt))
                   for s, dt in members]
        n, secs = serve(sched, f"serve dense W={W}",
                        {"flux_update_blocked": SERVE_DENSE_STEPS})
        cohort = next(iter(sched.cohorts.values()))
        check(cohort.W == W, f"serve dense: width {cohort.W} != {W}")
        for (s, dt), t in zip(members, tickets):
            ref = solo(adv_h, s, SERVE_DENSE_STEPS, dt)
            check(bits(t.result["density"], ref["density"]),
                  f"serve dense W={W}: member != its solo step loop")
        log(f"[serve] dense advection 128x128x64 cohort W={W}: {n / secs!r} member-steps/s "
            f"({n} member-steps in {secs!r} s, k={SERVE_DENSE_K}), "
            f"{SERVE_DENSE_K} flux_update_blocked launches a dispatch (one a step), "
            f"member_hbm_bytes {cohort.member_hbm_bytes()} (stacked-tables equivalent "
            f"{cohort.member_hbm_bytes_stacked_tables()}); every member bitwise equal to "
            f"its solo step loop; on {card}")
        del sched, tickets, members, cohort
    # the member-axis launch (the wrapper on ready inputs) against its bound
    # (W x one member's), W = 16
    W = SERVE_DENSE_WIDTHS[-1]
    x = {k: torch.stack([v] * W) for k, v in s_h.items()}
    dts = torch.tensor([mts * (0.3 + 0.02 * w) for w in range(W)], dtype=torch.float32,
                       device=dev)
    ext = adv_h._extend
    a2 = (x["density"], *(p.contiguous() for p in ext.planes(x["density"], True)),
          x["vx"], x["vy"], x["vz"], *(p.contiguous() for p in ext.planes(x["vz"], True)),
          adv_h._mx, adv_h._my, adv_h._mz_up, adv_h._mz_dn, dts)
    kw2 = dict(block=adv_h.dense_kind[1], area=adv_h._area, inv_vol=adv_h._inv_vol)
    n2 = 64 * 128 * 128 * W
    member_row("flux_update_blocked", f"W={W} x 128x128x64, B=16, one step",
               lambda: K.flux_update_blocked(*a2, **kw2),
               lambda: K.flux_update_blocked_plain(*a2, **kw2),
               bound(5 * n2 * 4, STEP_FLOPS_PER_CELL * n2))
    del x, a2

    # 2. the plane kernel's cohort (B3): 128x128x63 on 3 slots
    g3 = (Grid().set_initial_length((128, 128, 63)).set_neighborhood_length(0)
          .set_periodic(True, True, True).set_load_balancing_method("BLOCK")
          .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1 / 128, 1 / 128, 1 / 63))
          .initialize(n_devices=3, device=dev))
    from dccrg_tpu_torch import Advection

    adv3 = Advection(g3, dtype=np.float32)
    check(adv3.dense_kind == ("plane",), f"serve plane: {adv3.dense_kind}")
    s3 = adv3.initialize_state()
    dt3 = 0.4 * adv3.max_time_step(s3)
    members = [({**s3, "density": s3["density"] * (1 + 0.01 * w)}, dt3 * (0.3 + 0.02 * w))
               for w in range(SERVE_PLANE_W)]
    sched = Scheduler(steps_per_dispatch=SERVE_PLANE_STEPS)
    tickets = [sched.submit(Scenario(adv3, s, SERVE_PLANE_STEPS, dt=dt)) for s, dt in members]
    n, secs = serve(sched, f"serve plane W={SERVE_PLANE_W}", {"flux_update": SERVE_PLANE_STEPS})
    for (s, dt), t in zip(members, tickets):
        check(bits(t.result["density"], solo(adv3, s, SERVE_PLANE_STEPS, dt)["density"]),
              "serve plane: member != its solo step loop")
    log(f"[serve] plane cohort 128x128x63 on 3 slots, W={SERVE_PLANE_W}: {n / secs!r} "
        f"member-steps/s, bitwise equal to solo; on {card}")
    x = {k: torch.stack([v] * SERVE_PLANE_W) for k, v in s3.items()}
    dts = torch.tensor([dt3] * SERVE_PLANE_W, dtype=torch.float32, device=dev)
    a3 = (adv3._extend(x["density"], True), x["vx"], x["vy"], adv3._extend(x["vz"], True),
          adv3._mx, adv3._my, adv3._mz_up, adv3._mz_dn, dts)
    kw3 = dict(area=adv3._area, inv_vol=adv3._inv_vol)
    n3 = 63 * 128 * 128 * SERVE_PLANE_W
    member_row("flux_update", f"W={SERVE_PLANE_W} x 128x128x63 on 3 slots, one step",
               lambda: K.flux_update(*a3, **kw3), lambda: K.flux_update_plain(*a3, **kw3),
               bound((3 * n3 + 2 * (21 + 2) * 3 * 128 * 128 * SERVE_PLANE_W) * 4,
                     STEP_FLOPS_PER_CELL * n3))
    del sched, tickets, members, x, a3, g3, adv3, s3

    # 3. the Vlasov dense cohort (B7): 32^3 x 8^3 bins
    gv = (Grid().set_initial_length((32, 32, 32)).set_neighborhood_length(0)
          .set_periodic(True, True, True)
          .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1 / 32,) * 3)
          .initialize(n_devices=1, device=dev))
    vl = Vlasov(gv, nv=8, dtype=np.float32)
    check(vl._fused_block > 0, "serve vlasov: no kernel path")
    sv = vl.initialize_state()
    dtv = 0.4 * vl.max_time_step()
    members = [({"f": sv["f"] * (1 + 0.01 * w)}, dtv * (0.3 + 0.02 * w))
               for w in range(SERVE_VLASOV_W)]
    sched = Scheduler(steps_per_dispatch=SERVE_VLASOV_K)
    tickets = [sched.submit(Scenario(vl, s, SERVE_VLASOV_STEPS, dt=dt)) for s, dt in members]
    n, secs = serve(sched, f"serve vlasov W={SERVE_VLASOV_W}",
                    {"vlasov_step": SERVE_VLASOV_STEPS})
    for (s, dt), t in zip(members, tickets):
        check(bits(t.result["f"], solo(vl, s, SERVE_VLASOV_STEPS, dt)["f"]),
              "serve vlasov: member != its solo step loop")
    log(f"[serve] Vlasov 32^3 x 512 cohort W={SERVE_VLASOV_W}, k={SERVE_VLASOV_K}: "
        f"{n * 32 ** 3 * 512 / secs!r} phase-space cell-updates/s ({n / secs!r} "
        f"member-steps/s), bitwise equal to solo; on {card}")
    f4 = torch.stack([sv["f"]] * SERVE_VLASOV_W)
    dts = torch.tensor([dtv * (0.3 + 0.02 * w) for w in range(SERVE_VLASOV_W)],
                       dtype=torch.float32, device=dev)
    kw7 = dict(block=vl._fused_block, inv_dx=vl._inv_dx, periodic=vl._periodic)
    a7 = (f4, None, None, vl._vx, vl._vy, vl._vz, dts)
    n7 = 32 ** 3 * 512 * SERVE_VLASOV_W
    # the wrapper: each member's scales (one small multiply) and the launch
    member_row("vlasov_step", f"W={SERVE_VLASOV_W} x 32^3 x 512 bins, one step",
               lambda: V.vlasov_step(*a7, **kw7),
               lambda: V.vlasov_step_blocked_plain(*a7, **kw7),
               bound((2 * n7 + 3 * 512) * 4,
                     VLASOV_FLOPS_PER_CELL * n7 + 2 * 10 * 32 * 32 * 512 * SERVE_VLASOV_W))
    del sched, tickets, members, f4, a7, sv, vl, gv

    # 3b. members of more than one slot: W = 3 members of D = 2 slabs each,
    # distinct data and dt.  B2 and B3 read their z masks at slot % D (random
    # masks here, so a wrong slot shows), B7 wraps each member's slab ring
    # (open and periodic z).  Each member-axis launch is held bitwise against
    # its twin and against three one-member launches with a scalar dt.
    Wm, Dm = 3, 2
    rng = np.random.default_rng(313)

    def rand(lo, hi, *shape):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    def members_vs_one(name, shape, member, plain, one):
        got = member()
        check(bits(got, plain()), f"serve {name} at {shape}: member axis != its twin")
        check(bits(got, torch.stack([one(w) for w in range(Wm)])),
              f"serve {name} at {shape}: member axis != one-member launches")

    nzl, ny, nx = 32, 128, 128
    fld = lambda: rand(-1.0, 1.0, Wm, Dm, nzl, ny, nx)
    pln = lambda: rand(-1.0, 1.0, Wm, Dm, 1, ny, nx)
    mask = lambda n: torch.tensor((rng.random(n) < 0.7).astype(np.float32), device=dev)
    masks = (mask(nx), mask(ny), mask(Dm * nzl), mask(Dm * nzl))
    dtm = rand(0.5, 1.0, Wm) * float(mts)
    rho, e_lo, e_hi, vx, vy, vz, v_lo, v_hi = (fld(), pln(), pln(), fld(), fld(), fld(),
                                               pln(), pln())
    kwb = dict(block=K.pick_step_block(nzl, ny, nx), area=adv_h._area,
               inv_vol=adv_h._inv_vol)
    ab = lambda w: tuple(t[w] for t in (rho, e_lo, e_hi, vx, vy, vz, v_lo, v_hi))
    members_vs_one(
        "flux_update_blocked", f"W={Wm} x D={Dm} x {nzl}x{ny}x{nx}",
        lambda: K.flux_update_blocked(*ab(slice(None)), *masks, dtm, **kwb),
        lambda: K.flux_update_blocked_plain(*ab(slice(None)), *masks, dtm, **kwb),
        lambda w: K.flux_update_blocked(*ab(w), *masks, float(dtm[w]), **kwb))
    r_ext = torch.cat([e_lo, rho, e_hi], dim=2)
    v_ext = torch.cat([v_lo, vz, v_hi], dim=2)
    kwp = dict(area=adv_h._area, inv_vol=adv_h._inv_vol)
    ap = lambda w: (r_ext[w], vx[w], vy[w], v_ext[w])
    members_vs_one(
        "flux_update", f"W={Wm} x D={Dm} x {nzl}x{ny}x{nx}",
        lambda: K.flux_update(*ap(slice(None)), *masks, dtm, **kwp),
        lambda: K.flux_update_plain(*ap(slice(None)), *masks, dtm, **kwp),
        lambda w: K.flux_update(*ap(w), *masks, float(dtm[w]), **kwp))
    del rho, e_lo, e_hi, vx, vy, vz, v_lo, v_hi, r_ext, v_ext
    fm = rand(0.0, 1.0, Wm, Dm, 16, 32, 32, 512)
    vb = [rand(-1.0, 1.0, 512) for _ in range(3)]
    dt7 = rand(0.5, 1.0, Wm) * float(dtv)
    for per in ((True, False, True), (True, False, False)):
        kwv = dict(block=4, inv_dx=np.full(3, 32.0), periodic=per)
        members_vs_one(
            "vlasov_step", f"W={Wm} x D={Dm} x 16x32x32 x 512 bins, periodic {per}",
            lambda: V.vlasov_step(fm, None, None, *vb, dt7, **kwv),
            lambda: V.vlasov_step_blocked_plain(fm, None, None, *vb, dt7, **kwv),
            lambda w: V.vlasov_step(fm[w], None, None, *vb, float(dt7[w]), **kwv))
    del fm
    log(f"[serve] member axis at W={Wm}, D={Dm} (distinct data and dt, random z masks): "
        f"B2 and B3 at {nzl}x{ny}x{nx} a slab, B7 at 16x32x32 x 512 bins a slab with "
        f"open and periodic z, each bitwise equal to its twin and to {Wm} one-member "
        f"launches with a scalar dt; on {card}")

    # 4. the split advection cohort on phase 17's grid (B9 on member tables)
    dt_sa = 0.4 * adv_s.max_time_step(s_sa)
    members = [({**s_sa, "density": s_sa["density"] * (1 + 0.01 * w)},
                dt_sa * (0.3 + 0.02 * w)) for w in range(SERVE_SPLIT_W)]
    sched = Scheduler(steps_per_dispatch=SERVE_SPLIT_K)
    tickets = [sched.submit(Scenario(adv_s, s, SERVE_SPLIT_STEPS, dt=dt)) for s, dt in members]
    # a step: the payload gather and the merge, one B9 launch each
    n, secs = serve(sched, f"serve split W={SERVE_SPLIT_W}",
                    {"ring_copy": 2 * SERVE_SPLIT_STEPS})
    for (s, dt), t in zip(members, tickets):
        check(bits(t.result["density"], solo(adv_s, s, SERVE_SPLIT_STEPS, dt)["density"]),
              "serve split: member != its solo split steps")
    n_sa = len(g_sa.get_cells())
    log(f"[serve] split advection cohort, {n_sa} leaves on 8 slots, W={SERVE_SPLIT_W}, "
        f"k={SERVE_SPLIT_K}: {n * n_sa / secs!r} leaf-updates/s ({n / secs!r} "
        f"member-steps/s), {2 * SERVE_SPLIT_K} ring_copy launches a dispatch (two a step "
        f"for all members), bitwise equal to solo split steps; on {card}")
    del sched, tickets, members

    # 5. the bench's ensemble sweep (microbench.py's ensemble_summary)
    t5 = time.perf_counter()
    g5 = (Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(0)
          .set_periodic(True, True, True)
          .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1 / 4,) * 3)
          .initialize(n_devices=1, device=dev))
    gol = GameOfLife(g5, allow_dense=False)
    cells = g5.get_cells()
    rng = np.random.default_rng(0)

    def fresh():
        return gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])

    st = fresh()
    gol.step(st)
    sync()
    t = time.perf_counter()
    for _ in range(SERVE_SWEEP_STEPS):
        st = gol.step(st)
    sync()
    solo_rate = SERVE_SWEEP_STEPS / (time.perf_counter() - t)
    log(f"[serve] ensemble sweep (GoL 4^3, gather step): solo {solo_rate!r} "
        f"scenario-steps/s on {card}")
    for B in SERVE_SWEEP_SIZES:
        for k in SERVE_SWEEP_KS:
            sched = Scheduler(steps_per_dispatch=k)
            iters = max(1, SERVE_SWEEP_STEPS // k)
            for i in range(B):
                sched.submit(Scenario(gol, fresh(), k * (iters + 1), tenant=f"t{i}"))
            sched.admit()
            sched.step_once()
            sync()
            t = time.perf_counter()
            for _ in range(iters):
                sched.step_once()
            sync()
            el = time.perf_counter() - t
            cohort = next(iter(sched.cohorts.values()))
            r = B * k * iters / el
            log(f"[serve] ensemble B={B} k={k}: {r!r} scenario-steps/s per chip, "
                f"amortization over solo {r / solo_rate!r}, hbm_bytes_per_member "
                f"{cohort.member_hbm_bytes()} shared / "
                f"{cohort.member_hbm_bytes_stacked_tables()} stacked, shared tables "
                f"{cohort.shared_args}")
    for k in SERVE_SWEEP_KS:
        c0, m0 = counter("ensemble.verify_checks"), counter("ensemble.verify_mismatches")
        sched = Scheduler(steps_per_dispatch=k, verify=True)
        for i in range(2):
            sched.submit(Scenario(gol, fresh(), 2 * k, tenant=f"v{i}"))
        sched.run()
        c1, m1 = counter("ensemble.verify_checks"), counter("ensemble.verify_mismatches")
        check(c1 > c0 and m1 == m0, f"serve ensemble oracle k={k}: checks {c1 - c0}, "
              f"mismatches {m1 - m0}")
        log(f"[serve] ensemble oracle k={k}: {c1 - c0} checks, 0 mismatches")
    log(f"[serve] ensemble sweep in {time.perf_counter() - t5:.2f} s")

    # 6. the bench's wide-halo sweep (microbench.py's wide_halo_summary), on
    # 2 slots so that ghost rows exist
    t6 = time.perf_counter()
    moore = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
             if (i, j, k) != (0, 0, 0)]
    prev = os.environ.get("DCCRG_ENSEMBLE_WIDE")
    for gdepth in SERVE_WIDE_GS:
        gw = (Grid().set_initial_length((6, 6, 6)).set_neighborhood_length(gdepth)
              .set_periodic(True, True, True)
              .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                            level_0_cell_length=(1 / 6,) * 3)
              .initialize(n_devices=2, device=dev))
        gw.add_neighborhood(7, moore)
        cells = gw.get_cells()
        local = torch.as_tensor(gw.epoch.local_mask, device=dev)
        res = {}
        try:
            for mode in ("wide", "legacy"):
                if mode == "wide":
                    os.environ.pop("DCCRG_ENSEMBLE_WIDE", None)
                else:
                    os.environ["DCCRG_ENSEMBLE_WIDE"] = "0"
                golw = GameOfLife(gw, hood_id=7, allow_dense=False)
                for k in SERVE_WIDE_KS:
                    iters = max(1, SERVE_WIDE_STEPS // k)
                    starts = [golw.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
                              for _ in range(SERVE_WIDE_B)]
                    sched = Scheduler()
                    tickets = [sched.submit(Scenario(golw, s, k * (iters + 1)))
                               for s in starts]
                    sched.admit()
                    cohort = next(iter(sched.cohorts.values()))
                    check((cohort._wide is not None) == (mode == "wide"),
                          f"serve wide g={gdepth}: {mode} cohort engaged "
                          f"{cohort._wide is not None}")
                    cohort.step(k)
                    sync()
                    H._amortization.clear()
                    t = time.perf_counter()
                    for _ in range(iters):
                        cohort.step(k)
                    sync()
                    el = time.perf_counter() - t
                    eps = H._amortization[golw.batch_step_spec().kind]
                    res[(mode, k)] = (SERVE_WIDE_B * k * iters / el, eps[0] / eps[1])
                    if mode == "wide":
                        # owned rows == an exchange every step (the legacy
                        # member program, alone)
                        for slot, s0 in enumerate(starts):
                            ref = solo(golw, s0, k * (iters + 1), None)
                            got = cohort.member_state(slot)
                            for f in ref:
                                check(bits(owned(got[f], local), owned(ref[f], local)),
                                      f"serve wide g={gdepth} k={k}: owned rows of "
                                      f"{f} != stepping with an exchange every step")
                    del sched, tickets, cohort
        finally:
            if prev is None:
                os.environ.pop("DCCRG_ENSEMBLE_WIDE", None)
            else:
                os.environ["DCCRG_ENSEMBLE_WIDE"] = prev
        budget = GameOfLife(gw, hood_id=7, allow_dense=False)._wide_spec().budget
        for k in SERVE_WIDE_KS:
            (rw, ew), (rl, el_) = res[("wide", k)], res[("legacy", k)]
            log(f"[serve] wide halo hood {gdepth} (budget {budget}) B={SERVE_WIDE_B} k={k}: "
                f"halo.exchanges_per_step {ew!r} wide / {el_!r} legacy, {rw!r} / {rl!r} "
                f"scenario-steps/s per chip (wide over legacy {rw / rl!r}); owned rows "
                f"bitwise equal to an exchange every step")
        del gw
    log(f"[serve] wide-halo sweep in {time.perf_counter() - t6:.2f} s")

    # 7. the fleet gateway: 2 workers of one slot on the card, a worker and
    # then the gateway SIGKILLed, the gateway relaunched over its journal
    t7 = time.perf_counter()
    rep = {}
    ok = run_fleet(0, 1, n_workers=2, n_devices=1, device="cuda",
                   n_specs=SERVE_FLEET_SPECS, report=rep)
    r = rep.get(0, {})
    check(r.get("retired") == SERVE_FLEET_SPECS and not r.get("failures"),
          f"serve fleet: {r.get('failures')}")
    log(f"[serve] fleet: {r['retired']} of {r['accepted']} accepted scenarios retired "
        f"exactly once (GoL bitwise, advection within 1e-11 of the solo oracle) across "
        f"a gateway SIGKILL and {r['kills'] + 1} worker kills; postmortems name "
        f"{r['lost_named']}; generations {r['generations']}, redispatches "
        f"{r['redispatches']}, epoch.recompiles by worker {r['recompiles']}, fleet p99 "
        f"{r['fleet_p99_s']!r} s; (p50, p99) s of the merged worker streams "
        f"{r['latency_p50_p99_s']}; {r['seconds']!r} s on {card}")
    # the admission A/B (A16), run by run_fleet after the seeds
    ab = rep.get("admission_ab") or {}
    on, off = ab.get("on") or {}, ab.get("off") or {}
    check(ok and on and off and not ab.get("failures"),
          f"serve fleet admission A/B: {ab.get('failures')} (on {on}, off {off})")
    log(f"[serve] fleet admission A/B (one worker a mode): burst chunk {ab['chunk']} steps "
        f"from the warm-up's burst rate {ab['rate']!r} member-steps/s (an off-mode round "
        f">= {AB_ROUND_DEADLINES!r} x the deadline tenant's {AB_DL_DEADLINE_S!r} s); "
        f"admission on: {on['rejected']} of 4 burst submissions rejected, deadline tenant "
        f"miss {on['miss']} / ok {on['ok']} ({ab['on_s']!r} s); admission off: rejected "
        f"{off['rejected']}, miss {off['miss']} / ok {off['ok']} ({ab['off_s']!r} s); "
        f"{ab['seconds']!r} s in all; the fleet and the A/B "
        f"{time.perf_counter() - t7:.2f} s on {card}")
    log(f"[serve] phase 31 in {time.perf_counter() - t_phase:.2f} s")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1

    import numpy as np

    from dccrg_tpu_torch import (Advection, CartesianGeometry, GameOfLife, Grid,
                                 Particles, Poisson, Vlasov, cuda_build)
    from dccrg_tpu_torch.core import neighbors as NB
    from dccrg_tpu_torch.io import checkpoint as CK
    from dccrg_tpu_torch.models import advection as A_mod
    from dccrg_tpu_torch import obs
    from dccrg_tpu_torch.parallel.boxed import build_boxed
    from dccrg_tpu_torch.parallel.epoch import build_epoch
    from dccrg_tpu_torch.parallel.shapes import epoch_shape_hints
    from dccrg_tpu_torch.ops import dense_advection as K
    from dccrg_tpu_torch.ops import flat_amr as F
    from dccrg_tpu_torch.ops import gol_kernel as G
    from dccrg_tpu_torch.ops import poisson_kernel as B
    from dccrg_tpu_torch.ops import resident as R
    from dccrg_tpu_torch.ops import vlasov_kernel as V
    from dccrg_tpu_torch.parallel import halo_dma as H
    from dccrg_tpu_torch.parallel.halo import HaloExchange

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    def collective_halo(g):
        """A schedule of ``g``'s default neighborhood on the collective
        transport (the plain gather): the exchange's reference."""
        os.environ["DCCRG_HALO_BACKEND"] = "collective"
        try:
            ex = HaloExchange(g.epoch, g.epoch.hoods[None], dev, hood_id=None)
        finally:
            del os.environ["DCCRG_HALO_BACKEND"]
        check(ex.backend == "collective", f"collective halo: {ex.backend}")
        return ex
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"{name}, power limit not read (nvidia-smi exit {smi.returncode})"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card: {card}")

    def sync():
        torch.cuda.synchronize()

    def counters(prefix):
        """The registry's counter series whose names start with ``prefix``,
        flat: ``{"name{labels}": value}`` (``"name"`` unlabelled)."""
        out = {}
        for name, series in obs.metrics.report()["counters"].items():
            if name.startswith(prefix):
                for lab, v in series.items():
                    out[f"{name}{{{lab}}}" if lab else name] = v
        return out

    def uniform_grid(shape, n_devices=1):
        nx, ny, nz = shape
        return (
            Grid()
            .set_initial_length((nx, ny, nz))
            .set_neighborhood_length(0)
            .set_periodic(True, True, True)
            .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(1.0 / nx, 1.0 / ny, 1.0 / nz))
            .initialize(n_devices=n_devices)
        )

    def refined_grid(n, radii, center, max_ref, periodic=(True, True, True),
                     n_devices=1, hood=0):
        """n^3 grid, each ball of ``radii`` around ``center`` refined in turn
        at the finest level so far (bench.py's measure_refined /
        _ball_refined_grid), on ``n_devices`` slots, neighborhood length
        ``hood``."""
        g = (
            Grid()
            .set_initial_length((n, n, n))
            .set_neighborhood_length(hood)
            .set_periodic(*periodic)
            .set_maximum_refinement_level(max_ref)
            .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(1.0 / n,) * 3)
            .initialize(n_devices=n_devices)
        )
        for rad in radii:
            ids = g.get_cells()
            r = np.linalg.norm(g.geometry.get_center(ids) - np.asarray(center), axis=1)
            lv = g.mapping.get_refinement_level(ids)
            g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
            g.stop_refining()
        return g

    def pic_setup(n_particles, length, *, max_ref=0, refine_ball=None,
                  balance_method=None, seed=0, n_devices=1):
        """The bench's PIC fixture (benchmarks/microbench.py's pic_setup) on
        the port: a periodic length^3 grid (cells within ``refine_ball`` of
        the centre refined once, then a ``balance_load`` under
        ``balance_method``), uniform particles from default_rng(seed), the
        capacity twice the largest occupancy, and the reference's rotating
        velocity field.  Returns (model, points, velocity field)."""
        g = (Grid().set_initial_length((length,) * 3).set_neighborhood_length(1)
             .set_periodic(True, True, True).set_maximum_refinement_level(max_ref)
             .set_load_balancing_method(balance_method or "RCB")
             .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / length,) * 3)
             .initialize(n_devices=n_devices))
        if refine_ball is not None:
            ids = g.get_cells()
            rr = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
            g.refine_completely_many(ids[rr < refine_ball])
            g.stop_refining()
        if balance_method is not None:
            g.balance_load()
        pts = np.random.default_rng(seed).uniform(0.0, 1.0, size=(n_particles, 3))
        occ = np.bincount(g.leaves.position(g.get_existing_cell(pts)))
        pc = Particles(g, max_particles_per_cell=2 * int(occ.max()))
        vel = pc.velocity_field(lambda c: np.stack(
            [0.5 - c[:, 1], c[:, 0] - 0.5, np.full(len(c), 0.05)], axis=-1))
        return pc, pts, vel

    def event_ms(fn, reps):
        """Mean device time of ``fn`` over ``reps`` calls (CUDA events).
        The timed calls queue behind a device-side sleep as long as their
        host-side issue (measured on a warm-up call), so the host's launch
        overhead does not open gaps between them — unless a call issues more
        kernels than the launch queue holds, as the twins' long runs do."""
        sync()
        t = time.perf_counter()
        fn()
        sync()
        issue_s = min(1.5 * reps * (time.perf_counter() - t), 2.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(issue_s * 2e9))     # cycles at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_src = cuda_build.BUILD_DIR / "barrier_probe.cu"
    probe_lib = cuda_build.BUILD_DIR / "libbarrier_probe.so"
    probe_src.write_text(BARRIER_PROBE)
    probe_nvcc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(probe_lib), str(probe_src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = cuda_build.build()
    probe_log, _ = probe_nvcc.communicate()
    check(probe_nvcc.returncode == 0,
          f"barrier probe: nvcc exit {probe_nvcc.returncode}\n{probe_log}")
    log(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for lib, info in built.items():
        log(f"[build] {lib}: {info['seconds']:.2f} s: {info['cmd']}")
        for line in info["ptxas"].splitlines():
            if any(k in line for k in ("registers", "spill", "error", "entry function")):
                log(f"[build]   {line.strip()}")

    # ------------------------------------------------ 2. kernels vs twins
    rng = np.random.default_rng(1234)

    def inputs(D, nzl, ny, nx, seed=None):
        r = rng if seed is None else np.random.default_rng(seed)
        shape = (D, nzl, ny, nx)
        rho = r.uniform(0.1, 1.0, shape)
        vx, vy = r.normal(0.0, 0.5, shape), r.normal(0.0, 0.5, shape)
        z = (np.arange(D * nzl) + 0.5) / (D * nzl)
        vz = 0.3 * np.sin(2 * np.pi * z).reshape(D, nzl, 1, 1) \
            + r.normal(0.0, 0.05, shape)
        t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)
        l0 = np.array([1.0 / nx, 1.0 / ny, 1.0 / (D * nzl)])
        area = tuple(float(a) for a in np.array(
            [l0[1] * l0[2], l0[0] * l0[2], l0[0] * l0[1]]).astype(np.float32))
        mzu = np.ones((D, nzl))
        mzu[-1, -1] = 0.0          # non-periodic z: exercise a masked face
        mzd = np.roll(mzu.reshape(-1), 1).reshape(D, nzl)
        return dict(rho=t(rho), vx=t(vx), vy=t(vy), vz=t(vz),
                    mx=t(np.ones(nx)), my=t(np.ones(ny)), mzu=t(mzu), mzd=t(mzd),
                    area=area, inv_vol=float(np.float32(1.0 / l0.prod())),
                    dt=float(np.float32(0.2 / max(nx, ny, D * nzl))))

    def edges(a):
        return torch.roll(a[:, -1:], 1, 0), torch.roll(a[:, :1], -1, 0)

    def blocked_args(x):
        r_lo, r_hi = edges(x["rho"])
        v_lo, v_hi = edges(x["vz"])
        return (x["rho"], r_lo, r_hi, x["vx"], x["vy"], x["vz"], v_lo, v_hi,
                x["mx"], x["my"], x["mzu"], x["mzd"], x["dt"])

    def plane_args(x):
        ext = lambda a: torch.cat([edges(a)[0], a, edges(a)[1]], dim=1)
        return (ext(x["rho"]), x["vx"], x["vy"], ext(x["vz"]), x["mx"],
                x["my"], x["mzu"], x["mzd"], x["dt"])

    def fused_args(x, steps):
        return (x["rho"][0], x["vx"][0], x["vy"][0], x["vz"][0], x["mx"],
                x["my"], x["mzu"][0], x["mzd"][0], x["dt"], steps)

    twin_err = {}

    def same_bits(a, b):
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))

    def hold(label, kernel, plain, args, kw):
        """Kernel against twin on the same inputs: every output (a tensor
        or a tuple of them) bitwise equal.  Returns the max abs error."""
        before = dict(K.LAUNCHES)
        got = kernel(*args, **kw)
        sync()
        check(K.LAUNCHES != before, f"{label}: the kernel's launch count did not rise")
        want = plain(*args, **kw)
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{label}: kernel != twin (max abs err {err:.3e})")
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"{label}: non-finite output")
        log(f"[kernels] {label}: bitwise equal to its twin (max abs err {err})")
        return err

    x_b1 = inputs(1, 64, 128, 128)
    kw1 = dict(area=x_b1["area"], inv_vol=x_b1["inv_vol"])
    twin_err["fused_run"] = hold("B1 fused_run 128x128x64, 50 steps", K.fused_run,
                                 K.fused_run_plain, fused_args(x_b1, 50), kw1)
    for steps, what in ((7, "odd"), (0, "none"), (1, "one"), (300, "the race check")):
        twin_err["fused_run"] = max(twin_err["fused_run"], hold(
            f"B1 fused_run 128x128x64, {steps} steps ({what})", K.fused_run,
            K.fused_run_plain, fused_args(x_b1, steps), kw1))
    # the on-chip plan's other shapes: open x and z faces (zero masks), an
    # odd block no brick divides, the largest block fused_run_fits admits
    # at 128 x 128
    x_open = inputs(1, 64, 128, 128, seed=41)
    x_open["mx"][-1] = 0.0     # z is open in every input: mzu's last face is 0
    x67 = inputs(1, 67, 128, 128, seed=43)
    for label, x, steps in (("128x128x64, open x and z faces", x_open, 50),
                            ("33x17x9 (odd)", inputs(1, 9, 17, 33, seed=42), 40),
                            ("128x128x67 (largest admitted)", x67, 40)):
        check(K.fused_run_fits(*x["rho"].shape[1:]), f"{label}: not admitted")
        twin_err["fused_run"] = max(twin_err["fused_run"], hold(
            f"B1 fused_run {label}, {steps} steps", K.fused_run, K.fused_run_plain,
            fused_args(x, steps), dict(area=x["area"], inv_vol=x["inv_vol"])))
    check(not K.fused_run_fits(68, 128, 128), "128x128x68 admitted")
    limits = R.card_limits(dev.index)

    def refused(label, err):
        check(err == CUDA_INVALID_VALUE,
              f"{label}: not refused (cudaError_t {err}, expected {CUDA_INVALID_VALUE})")
        log(f"[kernels] {label}: refused before launch (cudaErrorInvalidValue)")

    # the launcher recomputes what the block needs from the plan's cut: the
    # headline's plan does not hold 128x128x67 (its bricks one plane deeper)
    p64 = K.fused_run_plan(64, 128, 128, *limits)
    deeper = tuple(-(-n // p) for n, p in zip((67, 128, 128), p64.parts))
    check(K.fused_smem_bytes(deeper, [p > 1 for p in p64.parts]) > p64.smem_bytes,
          "the headline's plan would hold 128x128x67")
    a67 = fused_args(x67, 1)
    out67 = torch.empty_like(a67[0])
    faces = torch.empty(2 * p64.ctas * 6 * p64.face_floats, device=dev)
    refused("B1 dense_fused_run: 128x128x64's plan on 128x128x67",
            K._kernels().dense_fused_run(
                *(t.data_ptr() for t in a67[:8]), out67.data_ptr(), faces.data_ptr(),
                67, 128, 128, 1, *K._consts(a67[8], kw1["area"], kw1["inv_vol"]),
                *p64.parts, *p64.threads, p64.smem_bytes, p64.face_floats,
                torch.cuda.current_stream().cuda_stream))
    x_b2 = inputs(1, 128, 512, 512)
    kw2 = dict(block=K.pick_step_block(128, 512, 512), area=x_b2["area"],
               inv_vol=x_b2["inv_vol"])
    check(kw2["block"] == 4, f"512x512x128 block is {kw2['block']}, expected 4")
    twin_err["flux_update_blocked"] = hold(
        "B2 flux_update_blocked 512x512x128 B=4", K.flux_update_blocked,
        K.flux_update_blocked_plain, blocked_args(x_b2), kw2)
    x_b2d = inputs(4, 8, 128, 128)
    hold("B2 flux_update_blocked 128x128x32 on 4 slabs B=8", K.flux_update_blocked,
         K.flux_update_blocked_plain, blocked_args(x_b2d),
         dict(block=8, area=x_b2d["area"], inv_vol=x_b2d["inv_vol"]))
    x_b3 = inputs(1, 63, 128, 128)
    kw3 = dict(area=x_b3["area"], inv_vol=x_b3["inv_vol"])
    twin_err["flux_update"] = hold("B3 flux_update 128x128x63", K.flux_update,
                                   K.flux_update_plain, plane_args(x_b3), kw3)
    x_b3d = inputs(3, 21, 128, 128)
    hold("B3 flux_update 128x128x63 on 3 slabs", K.flux_update,
         K.flux_update_plain, plane_args(x_b3d),
         dict(area=x_b3d["area"], inv_vol=x_b3d["inv_vol"]))

    # the refined grids of phases 6-7, built once: their voxel layouts are
    # the flat kernels' main-path shapes
    t = time.perf_counter()
    g_r = refined_grid(48, (0.3,), (0.3, 0.5, 0.5), 1)
    adv_r = Advection(g_r, dtype=np.float32, allow_dense=False)
    check(adv_r._flat_kind == "pallas" and not adv_r._prefer_boxed,
          f"refined dispatch {adv_r._flat_kind}, prefer boxed {adv_r._prefer_boxed}")
    check(adv_r._flat_run.shape == (96, 96, 96), f"refined voxels {adv_r._flat_run.shape}")
    s_r = adv_r.initialize_state()
    dt_r = 0.4 * adv_r.max_time_step(s_r)
    log(f"[refined] grid ({len(g_r.get_cells())} leaves) + model + state in "
        f"{time.perf_counter() - t:.2f} s, dt {dt_r!r}")
    t = time.perf_counter()
    g_m = refined_grid(16, (0.6, 0.55), (0.5, 0.5, 0.5), 2)
    adv_m = Advection(g_m, dtype=np.float32, allow_dense=False)
    check(adv_m._flat_kind == "ml_pallas" and not adv_m._prefer_boxed,
          f"refined3 dispatch {adv_m._flat_kind}, prefer boxed {adv_m._prefer_boxed}")
    check(adv_m._flat_run.shape == (64, 64, 64), f"refined3 voxels {adv_m._flat_run.shape}")
    s_m = adv_m.initialize_state()
    dt_m = 0.4 * adv_m.max_time_step(s_m)
    levels_m = sorted(set(g_m.mapping.get_refinement_level(g_m.get_cells()).tolist()))
    check(levels_m == [0, 1, 2], f"refined3 levels {levels_m}")
    log(f"[refined3] grid ({len(g_m.get_cells())} leaves, levels {levels_m}) + model "
        f"+ state in {time.perf_counter() - t:.2f} s, dt {dt_m!r}")

    def flat_args(adv, state, steps, dt, seed=None):
        """The flat kernel's main-path arguments; with ``seed``, a seeded
        random density in place of the initial hump (every voxel nonzero)."""
        fr = adv._flat_run
        args = list(fr.inputs(state))
        if seed is not None:
            args[0] = torch.tensor(np.random.default_rng(seed).uniform(
                0.1, 1.0, fr.shape).astype(np.float32), device=dev)
        return (*args, adv._scalar(dt), steps), fr.kwargs

    def flat_hold(label, kernel, plain, a, kw):
        err = hold(label, kernel, plain, a, kw)
        name = "flat_amr_run" if kernel is F.flat_amr_run else "flat_ml_run"
        twin_err[name] = max(twin_err.get(name, 0.0), err)

    def random_flat_args(shape, seed, kmax=None):
        """Seeded random density and signed CFL-scale weights on ``shape``;
        kmax None: B5's masks (fine or coarse 2x2x2 blocks), else B6's
        (random updf / pool, captures at random cube origins of each
        doubling up to kmax)."""
        r = np.random.default_rng(seed)
        t = lambda x: torch.tensor(np.ascontiguousarray(x, np.float32), device=dev)
        V = t(r.uniform(0.1, 1.0, shape))
        w = [t(r.uniform(-1e-2, 1e-2, shape)) for _ in range(6)]
        dt = float(np.float32(0.9))
        if kmax is None:
            blk = r.random(tuple(n // 2 for n in shape)) < 0.5
            fine = blk.repeat(2, 0).repeat(2, 1).repeat(2, 2)
            return (V, *w, t(fine / 1.0), t(~fine / 8.0), dt), {}
        grids = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij", sparse=True)
        caps = []
        for k in range(kmax + 1):
            f = 1 << (k + 1)
            origin = (grids[0] % f == 0) & (grids[1] % f == 0) & (grids[2] % f == 0)
            caps.append(t((origin & (r.random(shape) < 0.5)) / 8.0 ** (k + 1)))
        return ((V, *w, t(r.random(shape) < 0.5), t(r.random(shape) < 0.5), caps, dt),
                {"cap_active": [True] * (kmax + 1)})

    # B5 on the refined grid's 96^3 voxels (a seeded random density, then
    # its initial hump), about the parities and a long run (the race check)
    for steps in (0, 1, 7, 8, 50, 300):
        a, kw = flat_args(adv_r, s_r, steps, dt_r, seed=5)
        flat_hold(f"B5 flat_amr_run 96^3 voxels, {steps} steps, random density",
                  F.flat_amr_run, F.flat_amr_run_plain, a, kw)
    for steps in (8, 7):
        a, kw = flat_args(adv_r, s_r, steps, dt_r)
        flat_hold(f"B5 flat_amr_run 96^3 voxels, {steps} steps", F.flat_amr_run,
                  F.flat_amr_run_plain, a, kw)
    # a grid no plan divides evenly, and the largest flat_amr_fits admits,
    # whose weights do not fit on chip (the plan reads them from L2)
    n_big = (110, 110, 114)
    check(F.flat_amr_fits(int(np.prod(n_big))) and not F.flat_amr_fits(110 * 110 * 116),
          f"{n_big} is not the largest admitted at 110 x 110")
    for shape, steps in (((34, 18, 26), 41), (n_big, 40)):
        plan = F.flat_amr_run_plan(*shape, *limits)
        a, kw = random_flat_args(shape, 11)
        flat_hold(f"B5 flat_amr_run {'x'.join(map(str, shape))}, {steps} steps (plan "
                  f"{plan.parts}, weights {'on chip' if plan.weights_on_chip else 'in L2'})",
                  F.flat_amr_run, F.flat_amr_run_plain, (*a, steps), kw)
    # B6 on the refined3 grid's 64^3 voxels, the same counts
    for steps in (0, 1, 7, 8, 50, 300):
        a, kw = flat_args(adv_m, s_m, steps, dt_m, seed=6)
        flat_hold(f"B6 flat_ml_run 64^3 voxels, 3 levels, {steps} steps, random "
                  f"density", F.flat_ml_run, F.flat_ml_run_plain, a, kw)
    for steps in (8, 7):
        a, kw = flat_args(adv_m, s_m, steps, dt_m)
        flat_hold(f"B6 flat_ml_run 64^3 voxels, 3 levels, {steps} steps",
                  F.flat_ml_run, F.flat_ml_run_plain, a, kw)
    # a four-level grid (8^3, balls 0.6, 0.5, 0.35 refined in turn: cubes
    # of edge 8, doubling 2 through shared memory), and the largest grid
    # flat_ml_kernel_fits admits at three levels
    adv_4 = Advection(refined_grid(8, (0.6, 0.5, 0.35), (0.5, 0.5, 0.5), 3),
                      dtype=np.float32, allow_dense=False)
    check(adv_4._flat_kind == "ml_pallas" and adv_4._flat_run.kwargs["cap_active"] ==
          [True, True, True], f"four-level dispatch {adv_4._flat_kind}")
    s_4 = adv_4.initialize_state()
    for steps in (7, 50):
        a, kw = flat_args(adv_4, s_4, steps, 0.4 * adv_4.max_time_step(s_4), seed=8)
        flat_hold(f"B6 flat_ml_run 64^3 voxels, 4 levels (kmax 2), {steps} steps",
                  F.flat_ml_run, F.flat_ml_run_plain, a, kw)
    del adv_4, s_4
    m_big = (104, 108, 112)
    check(F.flat_ml_kernel_fits(int(np.prod(m_big)), 2)
          and not F.flat_ml_kernel_fits(104 * 108 * 116, 2),
          f"{m_big} is not the largest admitted at 104 x 108, 3 levels")
    plan = F.flat_ml_run_plan(*m_big, 1, *limits)
    a, kw = random_flat_args(m_big, 12, kmax=1)
    flat_hold(f"B6 flat_ml_run 104x108x112, 3 levels, 40 steps (plan {plan.parts}, "
              f"weights {'on chip' if plan.weights_on_chip else 'in L2'})",
              F.flat_ml_run, F.flat_ml_run_plain, (*a, 40), kw)
    # the launchers recompute what the grid needs from the plan's cut: the
    # 96^3 plan does not hold 98x96x96, nor the 64^3 plan 68x64x64
    p96 = F.flat_amr_run_plan(96, 96, 96, *limits)
    a, _ = random_flat_args((98, 96, 96), 13)
    out_f = torch.empty_like(a[0])
    faces_f = torch.empty(2 * p96.ctas * 6 * p96.face_floats, device=dev)
    refused("B5 flat_amr_run: 96^3's plan on 98x96x96",
            F._kernels().flat_amr_run(
                *(x.data_ptr() for x in a[:9]), out_f.data_ptr(), faces_f.data_ptr(),
                98, 96, 96, 1, *F._plan_args(p96),
                torch.cuda.current_stream().cuda_stream))
    p64 = F.flat_ml_run_plan(64, 64, 64, 1, *limits)
    a, _ = random_flat_args((68, 64, 64), 14, kmax=1)
    caps_f = torch.stack(a[9])
    out_f = torch.empty_like(a[0])
    faces_f = torch.empty(2 * p64.ctas * 6 * p64.face_floats, device=dev)
    refused("B6 flat_ml_run: 64^3's plan on 68x64x64",
            F._kernels().flat_ml_run(
                *(x.data_ptr() for x in a[:9]), caps_f.data_ptr(), out_f.data_ptr(),
                faces_f.data_ptr(), 68, 64, 64, 1, 1, 3, *F._plan_args(p64),
                torch.cuda.current_stream().cuda_stream))
    del a, out_f, faces_f, caps_f

    # B4 on the bench's board: 500x500, 30% alive; turns about the plan's
    # turns a round (k) and a long run (the race check); boards of one row,
    # one column and one tile; a board of finite non-0/1 values, held bit
    # for bit (the sign of a zero count included)
    board = torch.tensor((np.random.default_rng(7).random((500, 500)) < 0.3)
                         .astype(np.float32), device=dev)
    p500 = G.gol_run_plan(500, 500, *limits)
    k4 = p500.turns_per_round
    for px in (False, True):
        for turns in sorted({7, 8, 1, k4 - 1, k4, k4 + 1, 300} - {0}):
            err = hold(f"B4 gol_run 500x500, {'periodic' if px else 'open'}, "
                       f"{turns} turns", G.gol_run, G.gol_run_plain,
                       (board, turns, px, px), {})
            twin_err["gol_run"] = max(twin_err.get("gol_run", 0.0), err)
    for shape in ((1, 500), (500, 1), (5, 7)):
        b = torch.tensor((np.random.default_rng(8).random(shape) < 0.4)
                         .astype(np.float32), device=dev)
        for px in (False, True):
            twin_err["gol_run"] = max(twin_err["gol_run"], hold(
                f"B4 gol_run {shape[0]}x{shape[1]}, {'periodic' if px else 'open'}, "
                f"37 turns", G.gol_run, G.gol_run_plain, (b, 37, px, px), {}))
    values = torch.tensor(np.random.default_rng(9).choice(
        [-1.0, 0.0, 0.5, 1.0, 2.0, 3.0], (500, 500)).astype(np.float32), device=dev)
    for px in (False, True):
        args = (values, k4 + 1, px, px)
        twin_err["gol_run"] = max(twin_err["gol_run"], hold(
            f"B4 gol_run 500x500 of values in {{-1, 0, 0.5, 1, 2, 3}}, "
            f"{'periodic' if px else 'open'}, {k4 + 1} turns", G.gol_run,
            G.gol_run_plain, args, {}))
        check(all(same_bits(a, b) for a, b in zip(G.gol_run(*args), G.gol_run_plain(*args))),
              "B4 on non-0/1 values: kernel and twin differ in their bits")
    # the 500x500 board's plan on a 1000x1000 board: its tiles twice as
    # long on each axis, over the plan's shared memory
    big = torch.zeros((1000, 1000), device=dev)
    out_b, cnt_b = torch.empty_like(big), torch.empty_like(big)
    scr_b = torch.empty((2, 1000, 1000), device=dev)
    refused("B4 gol_run: 500x500's plan on 1000x1000",
            G._kernels().gol_run(
                big.data_ptr(), out_b.data_ptr(), cnt_b.data_ptr(), scr_b.data_ptr(),
                1000, 1000, 1, 0, 0, *p500.parts, k4, *p500.threads, p500.smem_bytes,
                torch.cuda.current_stream().cuda_stream))

    # B7 at the bench's phase space: 32^3 cells x 8^3 bins, block 4; the
    # edge planes read from the slab ring by the kernel (the main path's
    # form), or given (the ring's planes, made here)
    def vlasov_args(D, periodic, seed, ring=True):
        r = np.random.default_rng(seed)
        f = torch.tensor(r.uniform(0.0, 1.0, (D, 32 // D, 32, 32, 512))
                         .astype(np.float32), device=dev)
        v = torch.tensor(r.uniform(-1.0, 1.0, (3, 512)).astype(np.float32),
                         device=dev)
        lo, hi = (None, None) if ring else (
            e.contiguous() for e in V.ring_edges(f, periodic[2]))
        kw = dict(block=4, inv_dx=np.full(3, 32.0), periodic=periodic)
        return (f, lo, hi, v[0].contiguous(), v[1].contiguous(),
                v[2].contiguous(), float(np.float32(0.4 / 32))), kw

    check(V.pick_vlasov_block(32, 32, 32, 512) == 4, "32^3 x 512 block is not 4")
    for D, per, ring in ((1, (True, True, True), True), (2, (True, True, False), True),
                         (2, (True, True, False), False)):
        a7, kw7 = vlasov_args(D, per, 11 + D, ring)
        err = hold(f"B7 vlasov_step 32^3 x 512 bins on {D} slab(s), "
                   f"{'periodic' if per[2] else 'open z'}, edge planes "
                   f"{'from the slab ring' if ring else 'given'}", V.vlasov_step,
                   V.vlasov_step_blocked_plain, a7, kw7)
        twin_err["vlasov_step"] = max(twin_err.get("vlasov_step", 0.0), err)

    def vlasov_shape_args(shape, periodic, seed):
        """Seeded f and bin velocities of any [D, nzl, ny, nx, B] shape,
        the edge planes from the slab ring."""
        D, nzl, ny, nx, nb = shape
        r = np.random.default_rng(seed)
        f = torch.tensor(r.uniform(0.0, 1.0, shape).astype(np.float32), device=dev)
        v = torch.tensor(r.uniform(-1.0, 1.0, (3, nb)).astype(np.float32), device=dev)
        lo = hi = None
        block = V.pick_vlasov_block(nzl, ny, nx, nb)
        check(block > 0, f"B7 {shape}: not admitted")
        kw = dict(block=block, inv_dx=np.array([nx, ny, D * nzl], float), periodic=periodic)
        return (f, lo, hi, *(v[i].contiguous() for i in range(3)),
                float(np.float32(0.4 / max(nx, ny, D * nzl)))), kw

    # open x and y, nv = 3 (27 bins: 4-byte copies, a ragged chunk), and the
    # largest plane pick_vlasov_block admits at 512 bins (32 x 66 cells)
    nx_big = V._VLASOV_VMEM_BUDGET // 24 // (32 * 512 * 4)
    check(V.pick_vlasov_block(2, 32, nx_big, 512) and
          not V.pick_vlasov_block(2, 32, nx_big + 1, 512),
          f"32 x {nx_big} is not the largest admitted plane at 512 bins")
    for shape, per, what in (((1, 32, 32, 32, 512), (False, False, True), "open x and y"),
                             ((2, 16, 32, 32, 27), (True, False, False), "nv = 3, open y and z"),
                             ((1, 32, 32, nx_big, 512), (True, True, True),
                              "the largest admitted plane")):
        a7, kw7 = vlasov_shape_args(shape, per, sum(shape))
        plan = V.vlasov_step_plan(*shape, *limits)
        err = hold(f"B7 vlasov_step {'x'.join(map(str, shape))} ({what}; plan: "
                   f"{plan.tile} tiles of {plan.chunk} bins, {plan.z_parts} z runs, "
                   f"{plan.ctas} CTAs)", V.vlasov_step, V.vlasov_step_blocked_plain, a7, kw7)
        twin_err["vlasov_step"] = max(twin_err["vlasov_step"], err)
    del a7

    # B8 on the flat tables of phases 12-13 (built once: they are the
    # whole-solve kernel's main-path shapes) and of a small grid with odd
    # extents, an open x axis and all three cell roles
    def poisson_model(g, **kw):
        c = g.geometry.get_center(g.get_cells())
        rhs = np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
        rhs -= rhs.mean()
        p = Poisson(g, dtype=np.float32, **kw)
        return p, p.initialize_state(rhs)

    t = time.perf_counter()
    g_p = refined_grid(32, (0.25,), (0.5, 0.5, 0.5), 1)
    p_p, s_p = poisson_model(g_p)
    n_p = len(g_p.get_cells())
    check(n_p == 48000, f"poisson leaves {n_p}, expected 48000")
    check(p_p._solve_fast is not None and p_p._bicg_has_coarse
          and p_p._flat_tables["shape"] == (64, 64, 64),
          f"poisson dispatch: fast {p_p._solve_fast is not None}")
    log(f"[poisson] grid ({n_p} leaves) + model + state in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    g_pu = uniform_grid((64, 64, 64))
    p_pu, s_pu = poisson_model(g_pu)
    check(p_pu._solve_fast is not None and not p_pu._bicg_has_coarse,
          "poisson_uniform dispatch")
    log(f"[poisson_uniform] grid + model + state in {time.perf_counter() - t:.2f} s")
    g_odd = (Grid().set_initial_length((9, 7, 5)).set_neighborhood_length(0)
             .set_periodic(False, True, True)
             .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1 / 9, 1 / 7, 1 / 5))
             .initialize())
    cells = g_odd.get_cells()
    ctr = g_odd.geometry.get_center(cells)
    odd_skip = cells[np.linalg.norm(ctr - 0.5, axis=1) < 0.2]
    odd_bnd = cells[(ctr[:, 0] < 1 / 9) & ~np.isin(cells, odd_skip)]
    odd_solve = cells[~np.isin(cells, odd_skip) & ~np.isin(cells, odd_bnd)]
    p_odd, s_odd = poisson_model(g_odd, solve_cells=odd_solve, skip_cells=odd_skip)
    s_odd = g_odd.set_cell_data(s_odd, "solution", odd_bnd,
                                np.random.default_rng(1).standard_normal(len(odd_bnd)))
    check(p_odd._solve_fast is not None and not p_odd._bicg_has_coarse,
          "odd-grid dispatch")
    inf = float("inf")
    for label, p, s, scalars in (
            ("64^3 voxels (poisson), 60 iterations", p_p, s_p, (60, 0.0, inf)),
            ("64^3 voxels (poisson), to residual 8.0", p_p, s_p, (60, 8.0, 10.0)),
            ("64^3 voxels (uniform), 60 iterations", p_pu, s_pu, (60, 0.0, inf)),
            ("9x7x5 open x, three roles, to residual 1e-3", p_odd, s_odd,
             (200, 1e-3, 10.0))):
        args = (*p._bicg_inputs(s), *scalars)
        kw = {"has_coarse": p._bicg_has_coarse}
        err = hold(f"B8 bicg_solve {label}", B.bicg_solve, B.bicg_solve_plain,
                   args, kw)
        twin_err["bicg_solve"] = max(twin_err.get("bicg_solve", 0.0), err)
        _x, res, it = B.bicg_solve(*args, **kw)
        log(f"[kernels]   {int(it[0])} iterations, best residual {float(res[0])!r}")
        if scalars[1] > 0:
            check(int(it[0]) < scalars[0] and float(res[0]) <= scalars[1],
                  f"B8 {label}: stopped at {int(it[0])} with {float(res[0])}")
        else:
            check(int(it[0]) == 60, f"B8 {label}: {int(it[0])} iterations")

    def bicg_synth(shape, hc, seed):
        """Seeded operands of any grid: a perturbed Laplacian (random
        positive face weights), 90% solve rows, with coarse rows random
        fine / coarse 2x2x2 blocks and the even-parity origins."""
        r = np.random.default_rng(seed)
        t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)
        w = [r.uniform(0.5, 1.5, shape) for _ in range(6)]
        scaling = -sum(w) * r.uniform(1.0, 1.1, shape)
        if hc:
            blk = r.random(tuple(n // 2 for n in shape)) < 0.5
            fine = blk.repeat(2, 0).repeat(2, 1).repeat(2, 2)
            g = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij", sparse=True)
            orig = (g[0] % 2 == 0) & (g[1] % 2 == 0) & (g[2] % 2 == 0)
        else:
            fine, orig = np.ones(shape, bool), np.zeros(shape, bool)
        solve = r.random(shape) < 0.9
        rhs = np.where(solve, r.standard_normal(shape), 0.0)
        return [t(rhs), t(0.1 * r.standard_normal(shape))] + [t(a) for a in w] + [
            t(scaling), t(fine), t(~fine), t(orig), t(solve), t(solve)]

    # the largest grids bicg_fits admits, with and without coarse rows: the
    # plan's l2 form (the state and weights read through L2)
    for shape, hc in (((100, 98, 98), True), ((98, 98, 100), False)):
        check(B.bicg_fits(int(np.prod(shape))) and
              not B.bicg_fits(int(np.prod(shape)) + 98 * 98),
              f"{shape} is not the largest bicg_fits admits at 98 x 98")
        plan = B.bicg_solve_plan(*shape, hc, *limits)
        check(plan.form == "l2", f"B8 {shape}: plan form {plan.form}")
        args = (*bicg_synth(shape, hc, 17), 60, 0.0, inf)
        twin_err["bicg_solve"] = max(twin_err["bicg_solve"], hold(
            f"B8 bicg_solve {'x'.join(map(str, shape))} ({'coarse rows' if hc else 'uniform'}"
            f", the largest admitted; plan {plan.form}, {plan.ctas} CTAs), 60 iterations",
            B.bicg_solve, B.bicg_solve_plain, args, {"has_coarse": hc}))
    del args

    # each launcher recomputes its cut from the plan: the 32^3 x 512 plan
    # (16 x 16 tiles of 16 bins) does not cover 32 x 4 x 4 x 27, nor the
    # poisson grid's plan (128 bricks of 2 x 16 x 64) a 66 x 64 x 64 grid
    p7 = V.vlasov_step_plan(1, 32, 32, 32, 512, *limits)
    a7, _ = vlasov_shape_args((1, 32, 4, 4, 27), (True, True, True), 5)
    out7 = torch.empty_like(a7[0])
    ones7 = torch.ones((1, 3), device=dev)
    refused("B7 vlasov_step: 32^3 x 512's plan on 32 x 4 x 4 x 27",
            V._kernels().vlasov_step(
                a7[0].data_ptr(), None, None, *(x.data_ptr() for x in a7[3:6]),
                out7.data_ptr(), 1, 1, 32, 4, 4, 27, 1, 1, 1, 1, ones7.data_ptr(),
                0.0, 0.0, 0.0, *V._plan_args(p7), torch.cuda.current_stream().cuda_stream))
    p8 = B.bicg_solve_plan(64, 64, 64, True, *limits)
    a8 = bicg_synth((66, 64, 64), True, 6)
    o8, r8 = torch.empty_like(a8[0]), torch.empty(1, device=dev)
    i8 = torch.empty(1, dtype=torch.int32, device=dev)
    s8 = torch.empty((9,) + tuple(a8[0].shape), device=dev)
    part8 = torch.empty(3 * p8.tiles, device=dev)
    refused("B8 bicg_solve: the poisson grid's plan on 66x64x64",
            B._kernels().bicg_solve(
                *(x.data_ptr() for x in a8), o8.data_ptr(), r8.data_ptr(), i8.data_ptr(),
                s8.data_ptr(), part8.data_ptr(), 66, 64, 64, 1, 60, 0.0, inf,
                *B._plan_args(p8), torch.cuda.current_stream().cuda_stream))
    del a7, out7, a8, o8, s8

    # B9 on the refined grid of phase 17, on 8 slots: its density exchange is
    # the ring copy's main-path shape; a three-field state covers the dtypes
    t = time.perf_counter()
    g_sa = refined_grid(48, (0.3,), (0.3, 0.5, 0.5), 1, n_devices=8)
    n_sa = len(g_sa.get_cells())
    check(n_sa == 198008, f"split_advection leaves {n_sa}, expected 198008")
    ex_sa = g_sa.halo()
    check(ex_sa.backend == "pallas" and len(ex_sa.ring_ks) > 0,
          f"8-slot halo: backend {ex_sa.backend}, rings {ex_sa.ring_ks}")
    cells_sa = g_sa.get_cells()
    r9 = np.random.default_rng(9)
    s9 = g_sa.new_state({"v": ((), np.float64), "mom": ((3,), np.float32),
                         "tag": ((), np.uint32)}, fill=-1)
    for k, vals in (("v", r9.standard_normal(n_sa)),
                    ("mom", r9.standard_normal((n_sa, 3)).astype(np.float32)),
                    ("tag", r9.integers(0, 2**32, n_sa, dtype=np.uint32))):
        s9 = g_sa.set_cell_data(s9, k, cells_sa, vals)
    log(f"[halo] grid ({n_sa} leaves on 8 slots) + state in "
        f"{time.perf_counter() - t:.2f} s")
    # 1- and 2-byte elements (the kernel's uint8_t and uint16_t words), bool
    # and bfloat16, and f32 (4,) rows for its 16-byte words
    s9n = g_sa.new_state({"flag": ((), np.uint8), "h": ((3,), np.float16)})
    s9n = g_sa.set_cell_data(s9n, "flag", cells_sa, r9.integers(0, 256, n_sa, dtype=np.uint8))
    s9n = g_sa.set_cell_data(s9n, "h", cells_sa,
                             r9.standard_normal((n_sa, 3)).astype(np.float16))
    D9, R9 = ex_sa.D, ex_sa.R
    raw = lambda *shape: torch.tensor(r9.integers(0, 256, shape, dtype=np.uint8), device=dev)
    s9x = {"b": raw(D9, R9).bitwise_and(1).to(torch.bool),
           "bf": raw(D9, R9, 4).view(torch.bfloat16), "i16": raw(D9, R9, 2).view(torch.int16),
           "w4": torch.tensor(r9.standard_normal((D9, R9, 4)), dtype=torch.float32, device=dev)}

    def b9_modes(label, state, ex=ex_sa):
        """Hold each of B9's three modes, one launch for all the fields of
        ``state``, bitwise against its twin, and the merge of the payload
        against the blocking gather, on ``ex``'s ring tables."""
        rings9, D9, R9 = ex._rings, ex.D, ex.R
        xs = list(state.values())
        runs = {}
        for mode, jobs in (("payload", [(x, rings9.send) for x in xs]),
                           ("blocking", [(x, rings9.full) for x in xs])):
            before = K.LAUNCHES["ring_copy"]
            runs[mode] = H.ring_gather(jobs)
            sync()
            check(K.LAUNCHES["ring_copy"] == before + 1, f"B9 {mode} {label}: launches")
            for x, got, want in zip(xs, runs[mode], H.ring_gather_plain(jobs)):
                check(same_bits(got, want), f"B9 {mode} {label} {x.dtype}: kernel != twin")
        # the merge reads stale ghost rows (each field's bytes inverted on
        # the rows the schedule refreshes), so the payload must overwrite
        # every one of them
        ghost = rings9.merge.view(D9, R9) >= 0
        stale = []
        for x in xs:
            # bytes, with an axis of their own: torch.where takes no uint32
            xb = x.unsqueeze(-1).view(torch.uint8)
            inv = xb ^ 1 if x.dtype == torch.bool else xb.bitwise_not()
            mask = ghost.view((D9, R9) + (1,) * (xb.dim() - 2))
            stale.append(torch.where(mask, inv, xb).view(x.dtype).squeeze(-1))
        jobs = [(x, rings9.merge, p) for x, p in zip(stale, runs["payload"])]
        before = K.LAUNCHES["ring_copy"]
        merged = H.ring_gather(jobs)
        sync()
        check(K.LAUNCHES["ring_copy"] == before + 1, f"B9 merge {label}: launches")
        for x, got, want, full in zip(xs, merged, H.ring_gather_plain(jobs), runs["blocking"]):
            check(same_bits(got, want), f"B9 merge {label} {x.dtype}: kernel != twin")
            check(same_bits(got.view(x.shape), full.view(x.shape)),
                  f"B9 merge {label} {x.dtype}: merge != blocking gather")
        plan = H.ring_gather_plan([(x, rings9.full) for x in xs])
        log(f"[kernels] B9 payload, blocking and merge of {label} "
            f"({', '.join(str(x.dtype) for x in xs)}): one launch each, bitwise equal to "
            f"the twin; merge == blocking; blocking plan {plan}")

    b9_modes("the three-field state", s9)
    b9_modes("the narrow state", s9n)
    b9_modes("bool, bfloat16, int16 and f32 (4,)", s9x)
    # the particle state of phase 23 (the bench's refined PIC grid on 8
    # slots after an HSFC balance): 4-byte counts and rows of P x 3 f32
    t = time.perf_counter()
    pc_lb, pts_lb, vel_lb = pic_setup(PIC_REFINED_N, PIC_REFINED_GRID, max_ref=1,
                                      refine_ball=0.25, balance_method="HSFC", seed=1,
                                      n_devices=8)
    s_lb0 = pc_lb.new_state(pts_lb)
    log(f"[pic_refined_lb] grid ({len(pc_lb.grid.get_cells())} leaves on 8 slots, HSFC) + "
        f"model (P = {pc_lb.P}) + state of {PIC_REFINED_N} particles in "
        f"{time.perf_counter() - t:.2f} s")
    check(pc_lb._exchange.backend == "pallas" and len(pc_lb._exchange.ring_ks) > 0,
          f"pic_refined_lb halo: backend {pc_lb._exchange.backend}")
    b9_modes(f"the particle state (int32 counts, {pc_lb.P} x 3 f32 rows)",
             {k: s_lb0[k] for k in ("number_of_particles", "particles")}, ex=pc_lb._exchange)
    rings9 = ex_sa._rings
    # more fields than one launch carries: ceil(fields / RING_MAX_FIELDS)
    many = [x for st in (s9, s9n, s9x) for x in st.values()]
    before = K.LAUNCHES["ring_copy"]
    got = H.ring_gather([(x, rings9.full) for x in many])
    sync()
    n_launch = -(-len(many) // H.RING_MAX_FIELDS)
    check(K.LAUNCHES["ring_copy"] == before + n_launch,
          f"B9 {len(many)} fields: {K.LAUNCHES['ring_copy'] - before} launches, "
          f"expected {n_launch}")
    for x, y, want in zip(many, got, H.ring_gather_plain([(x, rings9.full) for x in many])):
        check(same_bits(y, want), f"B9 {len(many)} fields {x.dtype}: kernel != twin")
    log(f"[kernels] B9 blocking gather of {len(many)} fields: {n_launch} launches, bitwise "
        f"equal to the twin")
    ex9 = ex_sa(s9n)
    ref9 = collective_halo(g_sa)(s9n)
    for k in s9n:
        check(same_bits(ex9[k], ref9[k]) and not same_bits(ex9[k], s9n[k]),
              f"B9 exchange {k}: pallas != collective, or nothing moved")
    log("[kernels] B9 exchange of uint8 and f16 (3,): bitwise equal to the collective "
        "backend's")
    del s9n, s9x, ex9, ref9, many, got
    twin_err["ring_copy"] = 0.0
    os.environ["DCCRG_HALO_VERIFY"] = "1"
    ex_v = HaloExchange(g_sa.epoch, g_sa.epoch.hoods[None], dev, hood_id=None)
    ex_v(s9)
    ex_v.finish(s9, ex_v.start(s9))
    del os.environ["DCCRG_HALO_VERIFY"]
    check(ex_v.verify_checks == 6 and ex_v.verify_mismatches == {},
          f"verify: {ex_v.verify_checks} checks, mismatches {ex_v.verify_mismatches}")
    log(f"[kernels] DCCRG_HALO_VERIFY=1: {ex_v.verify_checks} checks (blocking and "
        f"split), no mismatch")

    def obs_phase(adv_s, s_sa, dt_sa, adv_a, s_a, dt_r, adv_h, s_h, dt_h):
        """Phase 29: the observability plane's overhead, its profiled and
        merged device timeline, its memory gauges, and its hooks and files
        on a small workload (see the module docstring)."""
        # overhead: telemetry on and disable()d in turns (off, on, on, off),
        # five rounds; a round's ratio is its two on runs over its two off
        # runs, so a drift of the card's or the host's speed across the
        # rounds cancels, and the median of the five is the result
        for label, fn in (("split_advection 50 steps",
                           lambda: adv_s.run(s_sa, 50, dt_sa)),
                          ("refined run(200)", lambda: adv_a.run(s_a, 200, dt_r))):
            for _ in range(3):
                fn()
            times = {True: [], False: []}
            ratios = []
            for _ in range(5):
                got = {True: 0.0, False: 0.0}
                for on in (False, True, True, False):
                    (obs.enable if on else obs.disable)()
                    sync()
                    t = time.perf_counter()
                    fn()
                    sync()
                    secs = time.perf_counter() - t
                    got[on] += secs
                    times[on].append(secs)
                ratios.append(got[True] / got[False])
            obs.enable()
            ratio = statistics.median(ratios)
            log(f"[obs] overhead, {label}: median on/off {ratio!r} (rounds "
                f"{[round(r, 5) for r in ratios]}; medians on "
                f"{statistics.median(times[True])!r} s, off "
                f"{statistics.median(times[False])!r} s; runs on "
                f"{[round(t, 6) for t in times[True]]}, off "
                f"{[round(t, 6) for t in times[False]]}) on {card}")
            check(ratio <= 1.10, f"obs: {label} on/off ratio {ratio:.4f} > 1.10")

        # a profiled round merged onto the host timeline
        obs.timeline.clear()
        with tempfile.TemporaryDirectory() as tmp:
            log_dir = os.path.join(tmp, "prof")
            with obs.profile_trace(log_dir):
                adv_s.run(s_sa, 5, dt_sa)
                adv_h.run(s_h, 50, dt_h)
            merged_path = os.path.join(tmp, "merged_trace.json")
            merged, summ = obs.merge_profile(log_dir, out_path=merged_path)
            bad = obs.validate_merged_trace(merged_path)
            check(bad == [], f"obs: merged trace invalid: {bad[:5]}")
            ing = obs.kineto.ingest(log_dir)
            log(f"[obs] Kineto categories seen: {ing.plane_names}")
            n_sync = len(obs.kineto.clock_syncs(ing))
            check(n_sync >= 2, f"obs: {n_sync} clock syncs")
            kern = summ["kernels"]
            check("halo.ring_copy" in kern and "fused_run" in kern,
                  f"obs: attribution misses halo.ring_copy / fused_run: {list(kern)[:12]}")
            # the busy share by hand from the raw trace: the union of the
            # device intervals over their first start to last end
            (raw_path,) = obs.kineto.find_trace_files(log_dir)
            with open(raw_path) as fh:
                raw = [e for e in json.load(fh)["traceEvents"]
                       if e.get("ph") == "X"
                       and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                       and float(e.get("dur", 0)) > 0]
            ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in raw)
            union, cur = 0.0, None
            for a, b in ivs:
                if cur is None or a > cur[1]:
                    union += 0.0 if cur is None else cur[1] - cur[0]
                    cur = [a, b]
                else:
                    cur[1] = max(cur[1], b)
            union += cur[1] - cur[0]
            span = max(b for _, b in ivs) - ivs[0][0]
            hand = union / span
            summed = sum(b - a for a, b in ivs) / span
            busy = obs.metrics.gauge_value("device.busy_fraction", device=0)
            check(busy is not None and abs(busy - hand) <= 0.02,
                  f"obs: merged busy share {busy} vs the hand count {hand}")
            frac = obs.metrics.gauge_value("overlap.fraction", phase="halo")
            check(frac is not None and 0.0 <= frac <= 1.0,
                  f"obs: overlap.fraction{{phase=halo}} {frac}")
            top = [(k, v["time_us"], v["count"]) for k, v in list(kern.items())[:8]]
            log(f"[obs] profiled 5 split steps + headline run(50): {summ['device_spans']} "
                f"device spans, {n_sync} clock syncs (spread "
                f"{summ['alignment']['spread_ns']!r} ns); busy share {busy!r} "
                f"(hand count, union {hand!r}; the sum of spans would say "
                f"{summed!r}); overlap.fraction{{phase=halo}} {frac!r}; window "
                f"{summ['window_s']!r} s; top kernels (label, us, launches) {top} "
                f"on {card}")
            for gap in merged.host_gaps(min_us=20.0, top=5):
                log(f"[obs] host gap {gap['dur_us']!r} us at {gap['start_us']!r} us: "
                    f"open host phases {gap['open_host_phases']}")

        # device memory gauges against the allocator
        g_h = refined_grid(24, (0.3,), (0.3, 0.5, 0.5), 1)
        got = obs.sample_hbm()
        alloc, peak = torch.cuda.memory_allocated(0), torch.cuda.max_memory_allocated(0)
        total = torch.cuda.mem_get_info(0)[1]
        check(got.get(0) == {"bytes_in_use": alloc, "peak_bytes_in_use": peak,
                             "bytes_limit": total},
              f"obs: sample_hbm {got} vs allocator {alloc}, {peak}, {total}")
        check(obs.metrics.gauge_value("hbm.bytes_in_use", device=0) == alloc,
              "obs: hbm.bytes_in_use gauge")
        log(f"[obs] sample_hbm after a refined epoch build ({len(g_h.get_cells())} "
            f"leaves): {got[0]} == memory_allocated / max_memory_allocated / "
            f"mem_get_info total")
        del g_h

        # every instrumented phase fires; the files pass the port's readers
        before = obs.metrics.report()
        g_o = refined_grid(16, (0.3,), (0.5, 0.5, 0.5), 1, n_devices=8)
        g_o.set_partitioning_option("LB_METHOD", "HSFC")
        s_o = g_o.new_state({"v": ((), np.float32), "w": ((3,), np.float32)})
        s_o = g_o.update_copies_of_remote_neighbors(s_o)
        g_o.balance_load()
        s_o = g_o.update_copies_of_remote_neighbors(g_o.remap_state(s_o))
        ids_o = g_o.get_cells()
        g_o.refine_completely_many(ids_o[g_o.mapping.get_refinement_level(ids_o) == 0][:3])
        g_o.stop_refining()
        s_o = g_o.update_copies_of_remote_neighbors(g_o.remap_state(s_o))
        with tempfile.TemporaryDirectory() as tmp:
            stream_path = os.path.join(tmp, "telemetry.json.stream.jsonl")
            st = obs.TelemetryStream(stream_path, truncate=True)
            st.write_snapshot()
            g_o.save_grid_data(s_o, os.path.join(tmp, "c.dc"),
                               {"v": ((), np.float32), "w": ((3,), np.float32)})
            st.write_snapshot()
            after = obs.metrics.report()
            fired = {}
            for ph in ("halo.exchange", "epoch.build", "loadbalance.migrate",
                       "amr.refine", "checkpoint.write"):
                fired[ph] = (after["phases"].get(ph, {}).get("count", 0)
                             - before["phases"].get(ph, {}).get("count", 0))
                check(fired[ph] > 0, f"obs: phase {ph} did not fire")
            bytes_ = {}
            for name in ("halo.bytes_moved", "checkpoint.bytes_written"):
                bytes_[name] = (sum(after["counters"].get(name, {}).values())
                                - sum(before["counters"].get(name, {}).values()))
                check(bytes_[name] > 0, f"obs: {name} did not count")
            tele = os.path.join(tmp, "telemetry.json")
            obs.export_json(tele, extra={"workload": "chip_smoke obs"})
            rep = obs.slo.load_report(tele)
            check(set(rep) >= {"phases", "counters", "gauges", "histograms"}
                  and rep["counters"]["halo.bytes_moved"] == after["counters"]["halo.bytes_moved"],
                  "obs: telemetry.json does not read back")
            tail = obs.live.StreamTailer(stream_path)
            lines = tail.poll()
            check(len(lines) == 2 and tail.seq_gaps == tail.torn_tails == tail.bad_lines == 0
                  and all({"seq", "ts", "phases", "counters"} <= set(r) for r in lines),
                  f"obs: stream {len(lines)} lines, gaps {tail.seq_gaps}")
            trace = os.path.join(tmp, "telemetry.json.trace.json")
            obs.export_chrome_trace(trace)
            bad = obs.validate_merged_trace(trace)
            check(bad == [], f"obs: timeline trace invalid: {bad[:5]}")
            dump = obs.flight_recorder.dump(os.path.join(tmp, "flightrec.json"),
                                            reason="chip_smoke")
            bad = obs.validate_flightrec(dump)
            check(bad == [], f"obs: flight recorder dump invalid: {bad[:5]}")
            sizes = {os.path.basename(f): os.path.getsize(f)
                     for f in (tele, stream_path, trace, dump)}
        log(f"[obs] 8-slot workload: phases fired {fired}, byte counters {bytes_}; "
            f"telemetry.json, stream, timeline trace and flight recorder dump "
            f"valid ({sizes} bytes); epoch.recompiles {counters('epoch.recompiles')}")
        del g_o, s_o

    # ------------------------------------------------ 3-11. the main path
    launches = {}

    def drive(label, fn, expect):
        """Run ``fn`` with every count at 0; the counts after must be
        exactly ``expect`` and no twin may have run."""
        K.reset_counts()
        out = fn()
        sync()
        got, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
        check(got == {**{k: 0 for k in got}, **expect},
              f"{label}: launches {got}, expected {expect}")
        check(not any(plain.values()), f"{label}: a plain twin ran: {plain}")
        for k, v in expect.items():
            launches[k] = launches.get(k, 0) + v
        log(f"[{label}] launches {got}")
        return out

    def finite_mass(label, adv, state, out, rel):
        rho = out["density"]
        check(tuple(rho.shape) == tuple(state["density"].shape), f"{label}: shape")
        check(bool(torch.isfinite(rho).all()), f"{label}: non-finite density")
        m0, m1 = adv.total_mass(state), adv.total_mass(out)
        drift = abs(m1 - m0) / m0
        check(drift <= rel, f"{label}: mass drift {drift:.3e} > {rel:.1e}")
        log(f"[{label}] mass {m0!r} -> {m1!r} (relative drift {drift!r})")

    def rate(label, fn, n_cells, steps, reps=3, unit="cell-updates/s"):
        times = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t)
        secs = statistics.median(times)
        log(f"[{label}] {n_cells * steps / secs!r} {unit} "
            f"(median of {reps} runs of {steps} steps, {secs!r} s; runs "
            f"{[round(t, 6) for t in times]}) on {card}")
        return n_cells * steps / secs

    # 3. headline: the bench's 128x128x64, 5000 steps
    t = time.perf_counter()
    g = uniform_grid((128, 128, 64))
    adv = Advection(g, dtype=np.float32)
    check(adv.fused and adv.dense_kind == ("blocked_direct", 16),
          f"headline dispatch {adv.dense_kind}, fused={adv.fused}")
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)
    log(f"[headline] grid + model + state in {time.perf_counter() - t:.2f} s, dt {dt!r}")
    out = drive("headline", lambda: adv.run(state, 5000, dt), {"fused_run": 1})
    finite_mass("headline", adv, state, out, 1e-5)
    short = adv.run(state, 200, dt)
    twin = K.fused_run_plain(
        state["density"][0], state["vx"][0], state["vy"][0], state["vz"][0],
        adv._mx, adv._my, adv._mz_up[0], adv._mz_dn[0], adv._scalar(dt), 200,
        area=adv._area, inv_vol=adv._inv_vol)
    check(torch.equal(short["density"][0], twin), "headline: 200 steps != twin")
    adv64 = Advection(g, dtype=np.float64)
    s64 = {k: v.double() for k, v in state.items()}
    ref64 = adv64.run(s64, 200, adv._scalar(dt))["density"]
    rel64 = float((short["density"].double() - ref64).abs().max() / ref64.abs().max())
    check(rel64 < 1e-4, f"headline: f32 vs f64 step body, rel err {rel64:.3e}")
    log(f"[headline] 200 steps: bitwise equal to the twin; vs the f64 step "
        f"body max err / max density {rel64!r}")
    rate("headline", lambda: adv.run(state, 5000, dt), 128 * 128 * 64, 5000)
    adv_h, s_h, dt_h = adv, state, dt   # phase 29 profiles a headline run

    # 4. large: 512x512x128, the per-step blocked kernel
    t = time.perf_counter()
    g = uniform_grid((512, 512, 128))
    adv = Advection(g, dtype=np.float32)
    check(not adv.fused and adv.dense_kind == ("blocked_direct", 4),
          f"large dispatch {adv.dense_kind}, fused={adv.fused}")
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)
    log(f"[large] grid + model + state in {time.perf_counter() - t:.2f} s")
    out = drive("large", lambda: adv.step(adv.run(state, 200, dt), dt),
                {"flux_update_blocked": 201})
    finite_mass("large", adv, state, out, 1e-5)
    rate("large", lambda: adv.run(state, 200, dt), 512 * 512 * 128, 200)
    del g, adv, state, out

    # 5. plane: 63 z planes, which no z-block size divides
    g1 = uniform_grid((128, 128, 63))
    adv1 = Advection(g1, dtype=np.float32)
    g3 = uniform_grid((128, 128, 63), n_devices=3)
    adv3 = Advection(g3, dtype=np.float32)
    check(adv1.dense_kind == adv3.dense_kind == ("plane",) and not adv3.fused,
          f"plane dispatch {adv1.dense_kind} / {adv3.dense_kind}")
    s1, s3 = adv1.initialize_state(), adv3.initialize_state()
    dt = 0.4 * adv1.max_time_step(s1)
    out1, out3 = drive("plane", lambda: (adv1.step(s1, dt), adv3.run(s3, 50, dt)),
                       {"flux_update": 51})
    finite_mass("plane", adv3, s3, out3, 1e-5)
    cells = g1.get_cells()
    one = adv1.get_cell_data(out1, "density", cells)
    three = adv3.get_cell_data(adv3.step(s3, dt), "density", cells)
    check(np.array_equal(one, three), "plane: one slab != three slabs")
    rate("plane", lambda: adv3.run(s3, 50, dt), 128 * 128 * 63, 50)

    def flat_checks(label, adv, state, out, dt, steps, tol64):
        """Mass, 200 steps against the twin (bitwise) and against the
        float64 gather step (max error over the peak density <= tol64)."""
        finite_mass(label, adv, state, out, 1e-5)
        short = adv.run(state, steps, dt)
        fr = adv._flat_run
        twin = fr.write_back(state, fr.plain(*fr.inputs(state), adv._scalar(dt),
                                             steps, **fr.kwargs))
        check(torch.equal(short["density"], twin["density"]),
              f"{label}: {steps} steps != twin")
        adv64 = Advection(adv.grid, dtype=np.float64, allow_dense=False,
                          use_kernels=False)
        check(adv64._flat_kind is None and not adv64._prefer_boxed,
              f"{label}: f64 took {adv64._flat_kind}")
        s64 = {k: v.double() for k, v in state.items()}
        ref64 = adv64.run(s64, steps, adv._scalar(dt))["density"]
        local = adv.tables.local_mask
        diff = (short["density"].double() - ref64)[local].abs().max()
        rel64 = float(diff / ref64[local].abs().max())
        check(rel64 <= tol64, f"{label}: f32 flat vs f64 gather, rel err {rel64:.3e}")
        log(f"[{label}] {steps} steps: bitwise equal to the twin; vs the f64 "
            f"gather step max err / max density {rel64!r} (limit {tol64})")

    # 6. refined: the bench's two-level grid, 2000 steps through B5
    n_r = len(g_r.get_cells())
    out = drive("refined", lambda: adv_r.run(s_r, 2000, dt_r), {"flat_amr_run": 1})
    flat_checks("refined", adv_r, s_r, out, dt_r, 200, 1e-4)
    rate("refined", lambda: adv_r.run(s_r, 2000, dt_r), n_r, 2000,
         unit="leaf-updates/s")

    # 7. refined3: the bench's three-level grid, 1000 steps through B6
    n_m = len(g_m.get_cells())
    out = drive("refined3", lambda: adv_m.run(s_m, 1000, dt_m), {"flat_ml_run": 1})
    flat_checks("refined3", adv_m, s_m, out, dt_m, 200, 1e-4)
    rate("refined3", lambda: adv_m.run(s_m, 1000, dt_m), n_m, 1000,
         unit="leaf-updates/s")

    # 24. boxed: the boxed per-level passes against the flat kernels on the
    # refined and refined3 grids (neighbourhood length 0), and the edge the
    # card gives the dispatch (models/advection.py FLAT_BOXED_EDGE,
    # ML_BOXED_EDGE: prefer boxed when flat voxels > edge x boxed voxels)
    for label, adv_b, s_b0, dt_b0, kname in (
            ("refined", adv_r, s_r, dt_r, "flat_amr_run"),
            ("refined3", adv_m, s_m, dt_m, "flat_ml_run")):
        check(adv_b._boxed_run is not None, f"boxed {label}: no boxed layout")
        n_leaf = len(adv_b.grid.get_cells())
        n_box = sum(int(np.prod(b.shape)) for b in adv_b.boxed.boxes.values())
        n_flat = adv_b._flat_n_vox
        out_b = drive(f"boxed {label}", lambda: adv_b._boxed_run(s_b0, 200, dt_b0), {})
        finite_mass(f"boxed {label}", adv_b, s_b0, out_b, 1e-5)
        out_f = adv_b._flat_run.run(s_b0, 200, dt_b0)
        local = adv_b.tables.local_mask
        rel = float((out_b["density"] - out_f["density"])[local].abs().max()
                    / out_f["density"][local].abs().max())
        check(rel <= 1e-4, f"boxed {label}: 200 steps vs {kname}, rel err {rel:.3e}")
        r_box = rate(f"boxed {label}", lambda: adv_b._boxed_run(s_b0, 50, dt_b0),
                     n_leaf, 50, unit="leaf-updates/s (boxed passes)")
        r_flat = rate(f"boxed {label} flat", lambda: adv_b._flat_run.run(s_b0, 500, dt_b0),
                      n_leaf, 500, unit=f"leaf-updates/s ({kname})")

        def gather20(adv=adv_b, st=s_b0, dt=dt_b0):
            for _ in range(20):
                st = adv._general_step(st, adv._scalar(dt))
            return st

        r_gat = rate(f"boxed {label} gather", gather20, n_leaf, 20,
                     unit="leaf-updates/s (gather step)")
        log(f"[boxed {label}] boxed passes over the gather step {r_box / r_gat!r} "
            f"(leaf-updates/s, f32) on {card}")
        edge = (r_flat * n_flat) / (r_box * n_box)
        const = (A_mod.FLAT_BOXED_EDGE if adv_b._flat_kind == "pallas"
                 else A_mod.ML_BOXED_EDGE[adv_b._flat_kind])
        check(adv_b._prefer_boxed == (n_flat > const * n_box), f"boxed {label}: dispatch")
        log(f"[boxed {label}] 200 boxed steps vs {kname}: max err / max density {rel!r} "
            f"(limit 1e-4); {n_flat} flat voxels, {n_box} boxed voxels; measured edge "
            f"(flat voxel-updates/s over boxed) {edge!r}, the constant {const}; the "
            f"dispatch takes {'boxed' if adv_b._prefer_boxed else adv_b._flat_kind} on {card}")
    del out_b, out_f
    # where no flat form qualifies (float64 on two levels and one slot) run
    # is the gather step; the boxed passes timed beside it on the same model
    adv_64 = Advection(g_r, dtype=np.float64, allow_dense=False)
    check(adv_64._flat_kind is None and not adv_64._prefer_boxed
          and adv_64._boxed is A_mod._UNBUILT,
          f"boxed refined f64: dispatch {adv_64._flat_kind}, prefer {adv_64._prefer_boxed}")
    s_64 = {k: v.double() for k, v in s_r.items()}
    out_g = drive("boxed refined f64 run", lambda: adv_64.run(s_64, 20, dt_r), {})
    t = time.perf_counter()
    box_64 = adv_64._boxed_run
    build_s = time.perf_counter() - t
    out_b = box_64(s_64, 20, dt_r)
    local = adv_64.tables.local_mask
    rel = float((out_b["density"] - out_g["density"])[local].abs().max()
                / out_g["density"][local].abs().max())
    check(rel <= 1e-12, f"boxed refined f64: boxed vs gather, rel err {rel:.3e}")
    r_gat = rate("boxed refined f64 run", lambda: adv_64.run(s_64, 20, dt_r), n_r, 20,
                 unit="leaf-updates/s (run: the gather step, f64)")
    r_box = rate("boxed refined f64 boxed", lambda: box_64(s_64, 20, dt_r), n_r, 20,
                 unit="leaf-updates/s (boxed passes, f64)")
    log(f"[boxed refined f64] run takes the gather step (no flat form); 20 boxed steps "
        f"vs it: max err / max density {rel!r} (limit 1e-12); boxed passes over the "
        f"gather step {r_box / r_gat!r}; layout and run built in {build_s!r} s on {card}")
    del adv_64, s_64, out_g, out_b, box_64

    # 8. adapt: one adaptation cycle between two flat runs on the refined
    # grid, then one gather step
    m0 = adv_r.total_mass(s_r)
    # the adaptation's host seconds, split: the epoch rebuild (the delta
    # patch, or the full build it falls back to) and remap_state timed by
    # wrapping the grid's own methods
    split = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            split[name] = split.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    g_r._rebuild_incremental = timed("epoch rebuild", g_r._rebuild_incremental)
    g_r.stop_refining = timed("stop_refining", g_r.stop_refining)
    g_r.remap_state = timed("remap_state", g_r.remap_state)
    counts0 = counters("epoch.delta")

    def adapt_cycle():
        st = adv_r.run(s_r, 50, dt_r)
        sync()
        t = time.perf_counter()
        st = adv_r.check_for_adaptation(st)
        split["check_for_adaptation"] = time.perf_counter() - t
        t = time.perf_counter()
        new_adv, st, new_cells, removed = adv_r.adapt_grid(st)
        sync()
        split["adapt_grid"] = time.perf_counter() - t
        check(new_adv._flat_kind == "pallas" and new_adv._boxed is A_mod._UNBUILT,
              f"adapt: the adapted grid took {new_adv._flat_kind} or built a boxed layout")
        return new_adv, new_adv.run(st, 50, dt_r), new_cells, removed

    t = time.perf_counter()
    adv_a, s_a, new_cells, removed = drive("adapt", adapt_cycle, {"flat_amr_run": 2})
    n_a = len(g_r.get_cells())
    check(n_a != n_r and len(new_cells) and len(removed),
          f"adapt: leaves {n_r} -> {n_a}, {len(new_cells)} new, {len(removed)} removed")
    check(bool(torch.isfinite(s_a["density"]).all()), "adapt: non-finite density")
    m1 = adv_a.total_mass(s_a)
    check(abs(m1 - m0) / m0 <= 1e-5, f"adapt: mass drift {abs(m1 - m0) / m0:.3e}")
    log(f"[adapt] leaves {n_r} -> {n_a} ({len(new_cells)} new, {len(removed)} "
        f"removed) in {time.perf_counter() - t:.2f} s; mass {m0!r} -> {m1!r}")
    del g_r._rebuild_incremental, g_r.stop_refining, g_r.remap_state
    delta = {k: v - counts0.get(k, 0) for k, v in counters("epoch.delta").items()
             if v != counts0.get(k, 0)}
    t = time.perf_counter()
    build_epoch(g_r.mapping, g_r.topology, g_r.leaves, g_r.n_devices, g_r.neighborhoods,
                uniform_geometry=g_r._uniform_geometry(),
                shape_hints=epoch_shape_hints(g_r.epoch))
    full_s = time.perf_counter() - t
    t = time.perf_counter()
    check(build_boxed(g_r, None) is not None, "adapt: the adapted grid has no boxed layout")
    boxed_s = time.perf_counter() - t
    commit = split["stop_refining"] - split["epoch rebuild"]
    model = split["adapt_grid"] - split["stop_refining"] - split["remap_state"]
    log(f"[adapt] host seconds of one adaptation (ROADMAP.md P6: ~3 s at ~200k leaves "
        f"with the full rebuild): check_for_adaptation {split['check_for_adaptation']!r}, "
        f"adapt_grid {split['adapt_grid']!r} = commit_adaptation {commit!r} + epoch "
        f"rebuild {split['epoch rebuild']!r} (epoch_delta counts {delta}) + remap_state "
        f"{split['remap_state']!r} + the new model, velocities and exchange {model!r} "
        f"(no boxed layout: B5's voxels are within the edge times the leaves); a full "
        f"build_epoch of the adapted leaves {full_s!r} s, build_boxed {boxed_s!r} s, on {card}")
    # B5 against its twin on the adapted grid's voxel layout (after the
    # drive: these launches compare, they do not count)
    a, kw = flat_args(adv_a, s_a, 50, dt_r, seed=7)
    flat_hold(f"B5 flat_amr_run on the adapted grid ({n_a} leaves, "
              f"{'x'.join(map(str, adv_a._flat_run.shape))} voxels), 50 steps",
              F.flat_amr_run, F.flat_amr_run_plain, a, kw)
    stepped = drive("adapt step", lambda: adv_a.step(s_a, dt_r), {})
    check(bool(torch.isfinite(stepped["density"]).all()), "adapt step: non-finite")
    m2 = adv_a.total_mass(stepped)
    check(abs(m2 - m1) / m1 <= 1e-6, f"adapt step: mass drift {abs(m2 - m1) / m1:.3e}")
    log(f"[adapt step] one gather step on the card, mass {m1!r} -> {m2!r}")

    def gather_steps(n=20):
        st = s_a
        for _ in range(n):
            st = adv_a.step(st, dt_r)
        return st

    rate("adapt step", gather_steps, n_a, 20, unit="leaf-updates/s (gather step)")

    # 25. checkpoint: the adapted refined state saved from the card, checked,
    # and reloaded on 1 and 8 slots, whole and in chunks of 20,000 cells
    ck_dir = tempfile.mkdtemp(prefix="dccrg_ck_")
    ck_path = os.path.join(ck_dir, "refined.dc")
    spec_ck = adv_a.spec
    cells_a = g_r.get_cells()
    gat_a = Advection(g_r, dtype=np.float32, allow_dense=False, use_kernels=False)

    def checkpoint_cycle():
        secs = {}
        t = time.perf_counter()
        g_r.save_grid_data(s_a, ck_path, spec_ck, user_header=b"chip_smoke")
        secs["save"] = time.perf_counter() - t
        t = time.perf_counter()
        check(CK.quick_validate(ck_path) == 2, "checkpoint: quick_validate")
        secs["quick_validate"] = time.perf_counter() - t
        loaded = {}
        for n_dev in (1, 8):
            for chunked in (False, True):
                t = time.perf_counter()
                if chunked:
                    loader = Grid.start_loading_grid_data(ck_path, spec_ck, n_devices=n_dev)
                    chunks = 1
                    while loader.continue_loading_grid_data(max_cells=20_000):
                        chunks += 1
                    g2, s2, hdr = loader.finish_loading_grid_data()
                else:
                    g2, s2, hdr = Grid.load_grid_data(ck_path, spec_ck, n_devices=n_dev)
                sync()
                secs[f"load {n_dev} slot{'s' if n_dev > 1 else ''}"
                     + (f", {chunks} chunks" if chunked else "")] = time.perf_counter() - t
                check(hdr == b"chip_smoke" and np.array_equal(g2.get_cells(), cells_a),
                      f"checkpoint: {n_dev} slots, chunked {chunked}: header or leaves")
                for k in spec_ck:
                    check(np.array_equal(g2.get_cell_data(s2, k, cells_a).view(np.uint32),
                                         g_r.get_cell_data(s_a, k, cells_a).view(np.uint32)),
                          f"checkpoint: {n_dev} slots, chunked {chunked}: {k} != saved")
                loaded[(n_dev, chunked)] = (g2, s2)
        # 20 steps after the reload against 20 without: B5 on one slot; the
        # gather step on 8 (a ghost refresh first: the load fills owned rows)
        g1, s1 = loaded[(1, False)]
        a1 = Advection(g1, dtype=np.float32, allow_dense=False)
        check(a1._flat_kind == "pallas" and not a1._prefer_boxed,
              f"checkpoint: reloaded dispatch {a1._flat_kind}")
        r1 = a1.run(s1, 20, dt_r)
        w1 = adv_a.run(s_a, 20, dt_r)
        g8, s8 = loaded[(8, True)]
        a8 = Advection(g8, dtype=np.float32, allow_dense=False, use_kernels=False)
        r8 = a8.run(g8.update_copies_of_remote_neighbors(s8), 20, dt_r)
        w8 = gat_a.run(s_a, 20, dt_r)
        return secs, (g1, r1, w1), (g8, r8, w8)

    secs_ck, run1, run8 = drive("checkpoint", checkpoint_cycle,
                                {"flat_amr_run": 2, "ring_copy": 21})
    for label, (g2, got, want) in (("1 slot, B5", run1), ("8 slots, gather step", run8)):
        a2 = g2.get_cell_data(got, "density", cells_a)
        b2 = g_r.get_cell_data(want, "density", cells_a)
        check(np.array_equal(a2.view(np.uint32), b2.view(np.uint32)),
              f"checkpoint: 20 steps after the reload ({label}) != 20 without")
    ck_bytes = os.path.getsize(ck_path)
    log(f"[checkpoint] {len(cells_a)} leaves x {len(spec_ck)} f32 fields: {ck_bytes} bytes "
        f"written (counters {counters('checkpoint.')}); host seconds "
        f"{ {k: round(v, 4) for k, v in secs_ck.items()} } (unrounded: {secs_ck!r}); "
        f"reloaded rows bitwise equal by cell id on 1 and 8 slots, whole and chunked; "
        f"20 steps after the reload bitwise equal to 20 without (1 slot B5, 8 slots "
        f"gather) on {card}")
    del run1, run8

    # 26. vtk: the adapted refined grid with its density
    vtk_path = os.path.join(ck_dir, "refined.vtk")
    t = time.perf_counter()
    drive("vtk", lambda: g_r.write_vtk_file(
        vtk_path, {"density": g_r.get_cell_data(s_a, "density", cells_a)}), {})
    vtk_s = time.perf_counter() - t
    vtk_bytes = os.path.getsize(vtk_path)
    n_c = len(cells_a)
    head = open(vtk_path, "rb").read(200)
    check(head.startswith(b"# vtk DataFile Version 2.0\n") and b"BINARY" in head
          and vtk_bytes > n_c * (8 * 3 * 4 + 9 * 4 + 4 + 4), f"vtk: {vtk_bytes} bytes")
    log(f"[vtk] write_vtk_file of {n_c} leaves with density: {vtk_bytes} bytes in "
        f"{vtk_s!r} s host on {card}")
    for f in os.listdir(ck_dir):
        os.remove(os.path.join(ck_dir, f))
    os.rmdir(ck_dir)

    # 9. gol: the bench's Game of Life, 20000 turns through B4
    t = time.perf_counter()
    g_gol = Grid().set_initial_length((500, 500, 1)).set_neighborhood_length(1).initialize()
    cells = g_gol.get_cells()
    alive0 = cells[np.random.default_rng(0).random(len(cells)) < 0.3]
    gol = GameOfLife(g_gol)
    check(gol.fused, f"gol: no whole-run kernel (dense2d {gol.dense2d})")
    s_gol = gol.new_state(alive_cells=alive0)
    log(f"[gol] grid + model + state in {time.perf_counter() - t:.2f} s, "
        f"{len(alive0)} of {len(cells)} alive")
    out = drive("gol", lambda: gol.run(s_gol, 20000), {"gol_run": 1})
    per = 500 * 500
    got = out["is_alive"].to(torch.int32)
    check(tuple(got.shape) == tuple(s_gol["is_alive"].shape), "gol: shape")
    check(bool(((got == 0) | (got == 1)).all()), "gol: a cell is neither 0 nor 1")
    n_alive = int(got[0, :per].sum())
    check(0 < n_alive < per, f"gol: {n_alive} cells alive after 20000 turns")
    short = gol.run(s_gol, 200)
    a0 = (s_gol["is_alive"][0, :per].to(torch.int32) != 0).to(torch.float32)
    t_a, t_c = G.gol_run_plain(a0.reshape(500, 500), 200, False, False)
    check(torch.equal(short["is_alive"][0, :per].to(torch.int32),
                      t_a.reshape(-1).to(torch.int32))
          and torch.equal(short["live_neighbor_count"][0, :per].to(torch.int32),
                          t_c.reshape(-1).to(torch.int32)),
          "gol: 200 turns != twin")
    slow = GameOfLife(g_gol, allow_dense=False)
    fast50, slow50 = gol.run(s_gol, 50), slow.run(s_gol, 50)
    same = (set(gol.alive_cells(fast50).tolist()) == set(slow.alive_cells(slow50).tolist())
            and np.array_equal(
                g_gol.get_cell_data(fast50, "live_neighbor_count", cells),
                g_gol.get_cell_data(slow50, "live_neighbor_count", cells)))
    check(same, "gol: 50 turns != the general gather path")
    log(f"[gol] {n_alive} alive after 20000 turns; 200 turns equal to the twin, "
        f"50 turns equal to the general gather path (alive set and counts)")
    rate("gol", lambda: gol.run(s_gol, 20000), per, 20000)
    del slow, fast50, slow50

    # 10. vlasov: the bench's 32^3 x 8^3 phase space, 50 steps through B7
    t = time.perf_counter()
    g_v = uniform_grid((32, 32, 32))
    vl = Vlasov(g_v, nv=8, dtype=np.float32)
    check(vl._fused_block == 4, f"vlasov: fused block {vl._fused_block}")
    s_v = vl.initialize_state()
    dt_v = float(np.float32(0.4 * vl.max_time_step()))
    log(f"[vlasov] grid + model + state in {time.perf_counter() - t:.2f} s, dt {dt_v!r}")
    out = drive("vlasov", lambda: vl.run(s_v, 50, dt_v), {"vlasov_step": 50})
    check(tuple(out["f"].shape) == (1, 32, 32, 32, 512), "vlasov: shape")
    check(bool(torch.isfinite(out["f"]).all()), "vlasov: non-finite f")
    m0, m1 = vl.total_mass(s_v), vl.total_mass(out)
    check(abs(m1 - m0) / m0 <= 1e-5, f"vlasov: mass drift {abs(m1 - m0) / m0:.3e}")
    short = vl.run(s_v, 5, dt_v)
    f = s_v["f"]
    for _ in range(5):
        f = V.vlasov_step_blocked_plain(
            f, None, None, vl._vx, vl._vy, vl._vz, dt_v, block=vl._fused_block,
            inv_dx=vl._inv_dx, periodic=vl._periodic)
    check(torch.equal(short["f"], f), "vlasov: 5 steps != twin")
    vl64 = Vlasov(g_v, nv=8, dtype=np.float64)
    ref64 = vl64.run({"f": s_v["f"].double()}, 5, dt_v)["f"]
    rel64 = float((short["f"].double() - ref64).abs().max() / ref64.abs().max())
    check(rel64 < 1e-5, f"vlasov: f32 vs f64 plain step, rel err {rel64:.3e}")
    log(f"[vlasov] mass {m0!r} -> {m1!r} (relative drift {abs(m1 - m0) / m0!r}); "
        f"5 steps bitwise equal to the twin; vs the f64 plain step max err / "
        f"max f {rel64!r}")
    n_phase = 32 ** 3 * 512
    rate("vlasov", lambda: vl.run(s_v, 50, dt_v), n_phase, 50,
         unit="phase-space cell-updates/s")
    del vl64, ref64, short, f, out

    # 11. vlasov_amr: Vlasov on a refined grid, the general gather path
    t = time.perf_counter()
    g_va = refined_grid(16, (0.3,), (0.5, 0.5, 0.5), 1)
    va = Vlasov(g_va, nv=4, dtype=np.float32)
    check(va.info is None, "vlasov_amr: the refined grid took the dense path")
    s_va = va.initialize_state()
    dt_va = 0.4 * va.max_time_step()
    n_va = len(g_va.get_cells())
    log(f"[vlasov_amr] grid ({n_va} leaves) + model + state in "
        f"{time.perf_counter() - t:.2f} s")
    out = drive("vlasov_amr", lambda: va.run(s_va, 10, dt_va), {})
    check(bool(torch.isfinite(out["f"]).all()), "vlasov_amr: non-finite f")
    m0, m1 = va.total_mass(s_va), va.total_mass(out)
    check(abs(m1 - m0) / m0 <= 1e-5, f"vlasov_amr: mass drift {abs(m1 - m0) / m0:.3e}")
    log(f"[vlasov_amr] 10 gather steps on the card, mass {m0!r} -> {m1!r}")
    r = rate("vlasov_amr", lambda: va.run(s_va, 10, dt_va), n_va, 10,
             unit="leaf-updates/s (gather step, 64 bins a leaf)")
    log(f"[vlasov_amr] {n_va / r * 1e3!r} ms a step")

    # 12-13. poisson, poisson_uniform: the bench's solves through B8
    def solve60(p, s):
        return p.solve(s, max_iterations=60, stop_residual=0.0,
                       stop_after_residual_increase=inf)

    def poisson_phase(label, g, p, s, n_cells, target):
        p.solve(s, max_iterations=2, stop_residual=0.0)      # warm-up
        out, res, it = drive(label, lambda: solve60(p, s), {"bicg_solve": 1})
        sol = out["solution"]
        check(it == 60, f"{label}: {it} iterations")
        check(tuple(sol.shape) == tuple(s["solution"].shape)
              and bool(torch.isfinite(sol).all()), f"{label}: solution shape/finite")
        # against the float32 flat solve without the kernel, at
        # test_fused_bicg_matches_xla_flat's tolerances: a solve to
        # ``target``, or with None the 60-iteration solve
        plain = Poisson(g, dtype=np.float32, use_kernels=False)
        check(plain._solve_fast is None and plain._flat is not None,
              f"{label}: the plain flat solver")
        if target is None:
            (a, res_a, it_a), (b, res_b, it_b) = (out, res, it), solve60(plain, s)
        else:
            a, res_a, it_a = p.solve(s, max_iterations=60, stop_residual=target)
            b, res_b, it_b = plain.solve(s, max_iterations=60, stop_residual=target)
        ids = g.get_cells()
        sa = g.get_cell_data(a, "solution", ids)
        sb = g.get_cell_data(b, "solution", ids)
        check((target is None or (res_a <= target and res_b <= target))
              and abs(it_a - it_b) <= 1,
              f"{label}: to {target}: kernel {it_a} it, res {res_a}; plain "
              f"{it_b} it, res {res_b}")
        if it_a == it_b and target is not None:
            check(abs(res_a - res_b) <= 1e-5 * res_b, f"{label}: residuals {res_a} {res_b}")
            check(np.allclose(sa, sb, rtol=1e-5, atol=1e-7),
                  f"{label}: solution max diff {np.abs(sa - sb).max()}")
        else:
            check(np.allclose(sa, sb, rtol=1e-3, atol=1e-6),
                  f"{label}: solution max diff {np.abs(sa - sb).max()}")
        log(f"[{label}] 60 iterations, best residual {res!r}; "
            f"{'60 iterations' if target is None else f'to residual {target}'}"
            f": kernel {it_a} iterations ({res_a!r}), plain flat {it_b} "
            f"({res_b!r}), solution max diff {np.abs(sa - sb).max()!r} "
            f"(peak {np.abs(sb).max()!r})")
        # the timed length on a seeded random rhs, which neither stalls nor
        # ends at rounding level: the kernel against the plain flat solve,
        # whose torch sums associate otherwise, at the same tolerances
        s_rand = p.initialize_state(np.random.default_rng(5).standard_normal(len(ids)))
        (a, res_a, it_a), (b, res_b, it_b) = solve60(p, s_rand), solve60(plain, s_rand)
        sa = g.get_cell_data(a, "solution", ids)
        sb = g.get_cell_data(b, "solution", ids)
        log(f"[{label}] random rhs, 60 iterations: kernel residual {res_a!r}, "
            f"plain flat {res_b!r} (relative difference "
            f"{abs(res_a - res_b) / res_b!r}), solution max diff "
            f"{np.abs(sa - sb).max()!r} (peak {np.abs(sb).max()!r}), "
            f"{np.count_nonzero(~np.isclose(sa, sb, rtol=1e-5, atol=1e-7))} "
            f"of {len(ids)} cells outside rtol 1e-5 / atol 1e-7")
        check(it_a == it_b == 60 and abs(res_a - res_b) <= 1e-5 * res_b,
              f"{label}: random rhs: kernel {it_a} it, res {res_a}; plain "
              f"{it_b} it, res {res_b}")
        check(np.allclose(sa, sb, rtol=1e-5, atol=1e-7),
              f"{label}: random rhs: solution max diff {np.abs(sa - sb).max()}")
        rate(label, lambda: solve60(p, s), n_cells, 60, unit="cell-iterations/s")
        return res

    # the bench's rhs stalls on the refined grid (BiCG semi-converges: the
    # residual falls from 109 to 7.55 in 4 iterations, then rises); 8.0 is a
    # target both solves reach
    poisson_phase("poisson", g_p, p_p, s_p, n_p, 8.0)
    # the bench's rhs is an eigenvector of the uniform operator: one
    # iteration reaches rounding level, where the two solves' residuals are
    # noise, so the check is the 60-iteration solutions and the residual drop
    _o, res0, _i = p_pu.solve(s_pu, max_iterations=0)
    res_u = poisson_phase("poisson_uniform", g_pu, p_pu, s_pu, 64 ** 3, None)
    check(res_u <= 1e-4 * res0, f"poisson_uniform: residual {res0} -> {res_u}")

    def operator_check(label, g, fast_apply, tol):
        """``fast_apply(i, x)`` (0 = A, 1 = Aᵀ) against the gather operator
        on a seeded random vector, float64; max error over the peak."""
        ref = Poisson(g, dtype=np.float64, allow_flat=False, allow_rolled=False)
        ids = g.get_cells()
        v = np.random.default_rng(1).standard_normal(len(ids))
        x = g.set_cell_data(g.new_state(ref.spec), "solution", ids, v)["solution"]
        worst = 0.0
        for i in range(2):
            want = g.get_cell_data({"x": ref._apply(x, ref._mult_table(i))[0]}, "x", ids)
            got = g.get_cell_data({"x": fast_apply(i, x)}, "x", ids)
            err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
            check(err <= tol, f"{label}: operator {i} vs gather, {err:.3e} > {tol}")
            worst = max(worst, err)
        log(f"[{label}] A and Aᵀ against the gather operator (float64): max "
            f"error / max(1, peak) {worst!r} (limit {tol})")

    # 14. poisson3: the three-level grid on the multi-level flat operator
    t = time.perf_counter()
    g_p3 = refined_grid(16, (0.35, 0.25), (0.5, 0.5, 0.5), 2)
    p_p3, s_p3 = poisson_model(g_p3)
    n_p3 = len(g_p3.get_cells())
    levels3 = sorted(set(g_p3.mapping.get_refinement_level(g_p3.get_cells()).tolist()))
    check(n_p3 == 24368 and levels3 == [0, 1, 2], f"poisson3 leaves {n_p3}, levels {levels3}")
    check(p_p3._flat is not None and p_p3._flat_tables["vl"] == 2
          and p_p3._solve_fast is None, "poisson3 dispatch")
    log(f"[poisson3] grid ({n_p3} leaves, levels {levels3}) + model + state in "
        f"{time.perf_counter() - t:.2f} s")
    f64 = Poisson(g_p3, dtype=np.float64)
    fwd, rev, vox, wb, _m = f64._flat
    operator_check("poisson3", g_p3, lambda i, x: wb((fwd, rev)[i](vox(x))), 1e-13)
    p_p3.solve(s_p3, max_iterations=2, stop_residual=0.0)
    out, res, it = drive("poisson3", lambda: solve60(p_p3, s_p3), {})
    check(it == 60 and bool(torch.isfinite(out["solution"]).all()),
          f"poisson3: {it} iterations")
    log(f"[poisson3] 60 iterations, best residual {res!r}")
    rate("poisson3", lambda: solve60(p_p3, s_p3), n_p3, 60, unit="cell-iterations/s")
    del f64

    # 15. poisson_rolled: the poisson grid on the rolled operator
    p_ro, s_ro = poisson_model(g_p, allow_flat=False)
    check(p_ro._rolled is not None and p_ro._flat is None and p_ro._solve_fast is None,
          "poisson_rolled dispatch")
    r64 = Poisson(g_p, dtype=np.float64, allow_flat=False)
    check(r64._rolled is not None, "poisson_rolled: no f64 rolled operator")
    operator_check("poisson_rolled", g_p, lambda i, x: r64._rolled[i](x), 1e-12)
    p_ro.solve(s_ro, max_iterations=2, stop_residual=0.0)
    out, res, it = drive("poisson_rolled", lambda: solve60(p_ro, s_ro), {})
    check(it == 60 and bool(torch.isfinite(out["solution"]).all()),
          f"poisson_rolled: {it} iterations")
    log(f"[poisson_rolled] 60 iterations, best residual {res!r}")
    rate("poisson_rolled", lambda: solve60(p_ro, s_ro), n_p, 60, unit="cell-iterations/s")
    del r64

    def trace_kernels(fn):
        """The kernel events of a profiler trace of ``fn``: (start us, end
        us, stream, name) each."""
        from torch.profiler import ProfilerActivity, profile

        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        return [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"), e["name"])
                for e in events if e.get("cat") == "kernel"]

    # 16. halo: the 8-slot exchange, blocking and split, on the Grid
    def halo_both():
        blocking = g_sa.update_copies_of_remote_neighbors(s9)
        handle = g_sa.start_remote_neighbor_copy_updates(s9)
        return blocking, g_sa.wait_remote_neighbor_copy_updates(s9, handle)

    # one B9 launch a blocking exchange, one for start and one for finish,
    # whatever the field count
    blocking, merged = drive("halo", halo_both, {"ring_copy": 3})
    ex_c = collective_halo(g_sa)
    coll = ex_c(s9)
    for k in s9:
        check(same_bits(blocking[k], merged[k]) and same_bits(blocking[k], coll[k]),
              f"halo {k}: blocking / split / collective differ")
        check(not same_bits(blocking[k], s9[k]), f"halo {k}: nothing moved")
    log(f"[halo] ring distances {ex_sa.ring_distances}, S_k {ex_sa.ring_sizes}, "
        f"bytes_moved {ex_sa.bytes_moved(s9)}, wire_bytes {ex_sa.wire_bytes(s9)} "
        f"(three fields, 16 bytes a cell); blocking == start/wait == collective, "
        f"bitwise")
    # device time (CUDA events over 50 queued exchanges) and wall time (host
    # clock around one exchange and a synchronise, median of 50); the
    # allocator's new segments during the queued run show start/wait's
    # payload blocks waiting on record_stream events the queue holds back
    for label, fn in (("pallas blocking", lambda: ex_sa(s9)),
                      ("pallas start/wait", lambda: ex_sa.finish(s9, ex_sa.start(s9))),
                      ("collective blocking", lambda: ex_c(s9))):
        seg0 = torch.cuda.memory_stats()["segment.all.allocated"]
        dev_ms = event_ms(fn, 50)
        seg1 = torch.cuda.memory_stats()["segment.all.allocated"]
        walls = []
        for _ in range(50):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t) * 1e3)
        log(f"[halo] {label} exchange of the three fields: device {dev_ms!r} ms "
            f"(queued; {seg1 - seg0} new allocator segments), wall "
            f"{statistics.median(walls)!r} ms (synchronised) on {card}")
    g_1 = refined_grid(8, (0.3,), (0.5, 0.5, 0.5), 1)
    s_1 = g_1.new_state({"v": ((), np.float32)})
    h_1 = drive("halo one slot", lambda: g_1.start_remote_neighbor_copy_updates(s_1), {})
    check(h_1.payload == {"v": None} and h_1.event is None
          and g_1.wait_remote_neighbor_copy_updates(s_1, h_1)["v"] is s_1["v"],
          "halo one slot: start must return an empty handle")
    del blocking, merged, coll

    # 17. split_advection: the refined grid on 8 slots, split against eager
    t = time.perf_counter()
    adv_e = Advection(g_sa, dtype=np.float32, allow_dense=False, use_kernels=False)
    adv_s = Advection(g_sa, dtype=np.float32, overlap=True)
    check(adv_e._flat_run is None and adv_s._flat_run is None and adv_s.dense is None,
          "split_advection dispatch")
    s_sa = adv_s.initialize_state()
    dt_sa = 0.4 * adv_s.max_time_step(s_sa)
    log(f"[split_advection] models + state in {time.perf_counter() - t:.2f} s, "
        f"dt {dt_sa!r}")
    # a step starts the halo (one B9 launch) and finishes it (one)
    out = drive("split_advection", lambda: adv_s.run(s_sa, 200, dt_sa), {"ring_copy": 400})
    finite_mass("split_advection", adv_s, s_sa, out, 1e-5)
    se = sf = s_sa
    for i in range(20):
        se, sf = adv_e.step(se, dt_sa), adv_s.step(sf, dt_sa)
        check(same_bits(se["density"], sf["density"]),
              f"split_advection: step {i + 1} != the eager step")
    check(same_bits(adv_e.run(s_sa, 200, dt_sa)["density"], out["density"]),
          "split_advection: 200 steps != the eager steps")
    log("[split_advection] bitwise equal to the eager gather step after each of "
        "20 steps and after 200")
    rate("split_advection", lambda: adv_s.run(s_sa, 200, dt_sa), n_sa, 200,
         unit="leaf-updates/s (split step)")
    rate("split_advection eager", lambda: adv_e.run(s_sa, 200, dt_sa), n_sa, 200,
         unit="leaf-updates/s (eager gather step)")

    # 27. xla_flat: the flat XLA forms in torch — the z-slab sharded form on
    # the refined grid on 8 slots against the eager gather step, and the f64
    # multi-level pyramid form on refined3 against the f64 gather step
    adv_x = Advection(g_sa, dtype=np.float32, allow_dense=False)
    check(adv_x._flat_kind == "sharded" and not adv_x._prefer_boxed,
          f"xla_flat: 8-slot dispatch {adv_x._flat_kind}")
    out_x = drive("xla_flat sharded", lambda: adv_x.run(s_sa, 200, dt_sa), {})
    finite_mass("xla_flat sharded", adv_x, s_sa, out_x, 1e-5)
    ref_x = adv_e.run(s_sa, 200, dt_sa)
    loc = adv_x.tables.local_mask
    rel = float((out_x["density"] - ref_x["density"])[loc].abs().max()
                / ref_x["density"][loc].abs().max())
    check(rel <= 1e-4, f"xla_flat sharded: 200 steps vs the gather step, rel err {rel:.3e}")
    rate("xla_flat sharded", lambda: adv_x.run(s_sa, 200, dt_sa), n_sa, 200,
         unit="leaf-updates/s (sharded form, 8 slots)")
    log(f"[xla_flat sharded] 200 steps vs the eager gather step on 8 slots: max err / "
        f"max density {rel!r} (limit 1e-4)")
    adv_m64 = Advection(g_m, dtype=np.float64, allow_dense=False)
    gat_m64 = Advection(g_m, dtype=np.float64, allow_dense=False, use_kernels=False)
    check(adv_m64._flat_kind == "ml", f"xla_flat: f64 refined3 dispatch {adv_m64._flat_kind}")
    s_m64 = {k: v.double() for k, v in s_m.items()}

    def gather_m64(n=200):
        st = s_m64
        for _ in range(n):
            st = gat_m64.step(st, dt_m)
        return st

    out_ml = drive("xla_flat ml", lambda: adv_m64._flat_run.run(s_m64, 200, dt_m), {})
    finite_mass("xla_flat ml", adv_m64, s_m64, out_ml, 1e-12)
    ref_ml = gather_m64()
    loc = adv_m64.tables.local_mask
    rel = float((out_ml["density"] - ref_ml["density"])[loc].abs().max()
                / ref_ml["density"][loc].abs().max())
    check(rel <= 1e-11, f"xla_flat ml: 200 f64 steps vs the gather step, rel err {rel:.3e}")
    n_m3 = len(g_m.get_cells())
    rate("xla_flat ml", lambda: adv_m64._flat_run.run(s_m64, 200, dt_m), n_m3, 200,
         unit="leaf-updates/s (ml form, f64)")
    rate("xla_flat ml gather", lambda: gather_m64(20), n_m3, 20,
         unit="leaf-updates/s (gather step, f64)")
    log(f"[xla_flat ml] 200 f64 steps vs the f64 gather step: max err / max density "
        f"{rel!r} (limit 1e-11); the dispatch takes "
        f"{'boxed' if adv_m64._prefer_boxed else adv_m64._flat_kind}")
    del adv_x, out_x, ref_x, adv_m64, gat_m64, s_m64, out_ml, ref_ml

    def side_stream_overlap(label, fn):
        """Profile ``fn`` and log from the trace's kernel events: the ring
        copies' count, streams and device time (launches and mean us a
        launch a stream: the payloads run on the side stream, the merges on
        the model's), the part of it during which a kernel of another
        stream ran, and the device's busy share of the window from the first
        kernel's start to the last one's end."""
        kern = [(s, e, st, "ring_gather" in n) for s, e, st, n in trace_kernels(fn)]
        if not kern:
            log(f"[{label}] profiler: no device events; overlap and idle share "
                f"not measured")
            return
        ring = [k for k in kern if k[3]]
        other = [k for k in kern if not k[3]]
        ring_us = sum(e - s for s, e, _, _ in ring)
        over = sum(max(0.0, min(e, e2) - max(s, s2)) for s, e, st, _ in ring
                   for s2, e2, st2, _ in other if st2 != st)
        span = max(k[1] for k in kern) - min(k[0] for k in kern)
        busy = sum(e - s for s, e, _, _ in kern)
        per_stream = {}
        for s, e, st, _ in ring:
            per_stream.setdefault(st, []).append(e - s)
        means = {st: (len(v), sum(v) / len(v)) for st, v in per_stream.items()}
        log(f"[{label}] profiler, 5 split steps: {len(kern)} kernels, {len(ring)} "
            f"ring copies (stream: launches, mean us a launch {means}), "
            f"{ring_us!r} us of ring copy, {over!r} us of it beside a kernel of "
            f"another stream; kernels {busy!r} us of a {span!r} us window "
            f"(busy share {busy / span!r})")

    # what the device ran in phase 16's exchanges: one kernel a blocking
    # exchange, two a start/wait (no clone, no index_put_ of a field).  The
    # profiler runs only after the rates above, so they are taken in a
    # process that has not traced yet
    for label, fn, n_kern in (("blocking", lambda: ex_sa(s9), 1),
                              ("start/wait", lambda: ex_sa.finish(s9, ex_sa.start(s9)), 2)):
        fn()
        names = [k[3] for k in trace_kernels(fn)]
        check(len(names) == n_kern and all("ring_gather" in n for n in names),
              f"halo {label}: the trace holds kernels {names}, expected {n_kern} B9")
        log(f"[halo] profiled {label} exchange of the three fields: {len(names)} "
            f"kernel(s), all B9")
    side_stream_overlap("split_advection", lambda: adv_s.run(s_sa, 5, dt_sa))
    del se, sf, out

    # 29. obs: the observability plane on the card
    obs_phase(adv_s, s_sa, dt_sa, adv_a, s_a, dt_r, adv_h, s_h, dt_h)
    del adv_h, s_h

    # 18. split_vlasov: 512 bins on the refined 16^3 grid, 8 slots
    t = time.perf_counter()
    g_sv = refined_grid(16, (0.3,), (0.5, 0.5, 0.5), 1, n_devices=8)
    n_sv = len(g_sv.get_cells())
    check(n_sv == 7456, f"split_vlasov leaves {n_sv}, expected 7456")
    vl_e = Vlasov(g_sv, nv=8, dtype=np.float32)
    vl_s = Vlasov(g_sv, nv=8, dtype=np.float32, overlap=True)
    check(vl_e.info is None and vl_s.info is None, "split_vlasov: a dense layout")
    s_sv = vl_s.initialize_state()
    dt_sv = float(np.float32(0.4 * vl_s.max_time_step()))
    log(f"[split_vlasov] grid ({n_sv} leaves on 8 slots) + models + state in "
        f"{time.perf_counter() - t:.2f} s, dt {dt_sv!r}")
    # B9 at this path's shape: 2 KiB rows, the kernel's 16-byte words
    ex_sv = g_sv.halo()
    check(ex_sv.backend == "pallas" and len(ex_sv.ring_ks) > 0,
          f"split_vlasov halo: backend {ex_sv.backend}, rings {ex_sv.ring_ks}")
    jobs_sv = [(s_sv["f"], ex_sv._rings.send)]
    got, = H.ring_gather(jobs_sv)
    sync()
    check(same_bits(got, H.ring_gather_plain(jobs_sv)[0]),
          "B9 payload split_vlasov f: kernel != twin")
    # the state's ghost rows (not its pad rows) poisoned: one exchange must
    # restore them, on both backends alike
    ep = g_sv.epoch
    ghost = torch.as_tensor(~ep.local_mask & (ep.cell_len != 0), device=dev)
    stale = {"f": torch.where(ghost[..., None], -1.0, s_sv["f"])}
    eager_x = g_sv.update_copies_of_remote_neighbors(stale)
    coll_x = collective_halo(g_sv)(stale)
    check(same_bits(eager_x["f"], coll_x["f"]),
          "split_vlasov f: the exchange != the collective backend's")
    check(same_bits(eager_x["f"], s_sv["f"]), "split_vlasov f: ghosts not restored")
    log(f"[split_vlasov] B9 payload f {tuple(got.shape)}: bitwise equal to its "
        f"twin; an exchange of poisoned ghosts bitwise equal to the collective "
        f"backend's, and restores them")
    del got, ghost, stale, eager_x, coll_x
    out = drive("split_vlasov", lambda: vl_s.run(s_sv, 20, dt_sv), {"ring_copy": 40})
    check(bool(torch.isfinite(out["f"]).all()), "split_vlasov: non-finite f")
    m0, m1 = vl_s.total_mass(s_sv), vl_s.total_mass(out)
    check(abs(m1 - m0) / m0 <= 1e-5, f"split_vlasov: mass drift {abs(m1 - m0) / m0:.3e}")
    se = sf = s_sv
    for i in range(20):
        se, sf = vl_e.step(se, dt_sv), vl_s.step(sf, dt_sv)
        check(same_bits(se["f"], sf["f"]), f"split_vlasov: step {i + 1} != the eager step")
    check(same_bits(sf["f"], out["f"]), "split_vlasov: run(20) != 20 steps")
    log(f"[split_vlasov] 20 steps bitwise equal to the eager general step after "
        f"each; mass {m0!r} -> {m1!r}")
    rate("split_vlasov", lambda: vl_s.run(s_sv, 20, dt_sv), n_sv * 512, 20,
         unit="phase-space cell-updates/s (split step)")
    rate("split_vlasov eager", lambda: vl_e.run(s_sv, 20, dt_sv), n_sv * 512, 20,
         unit="phase-space cell-updates/s (eager general step)")
    side_stream_overlap("split_vlasov", lambda: vl_s.run(s_sv, 5, dt_sv))
    del se, sf, out

    # 19. split_gol: the bench's board on 8 slots, against the one-slot B4 run
    g_g8 = (Grid().set_initial_length((500, 500, 1)).set_neighborhood_length(1)
            .initialize(n_devices=8))
    gol8 = GameOfLife(g_g8, overlap=True)
    check(gol8.dense2d is None, "split_gol: took the dense path")
    s_g8 = gol8.new_state(alive_cells=alive0)
    out = drive("split_gol", lambda: gol8.run(s_g8, 200), {"ring_copy": 400})
    want = set(gol.alive_cells(gol.run(s_gol, 200)).tolist())
    got = set(gol8.alive_cells(out).tolist())
    check(got == want, f"split_gol: {len(got)} alive, the gol_run run {len(want)}")
    log(f"[split_gol] 200 turns on 8 slots: the alive set ({len(got)} cells) equals "
        f"the one-slot gol_run run's")
    rate("split_gol", lambda: gol8.run(s_g8, 200), per, 200,
         unit="cell-updates/s (split step)")
    del out

    # --------------------------------------------------------- 20. timing
    def bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    rows = []
    n1 = 64 * 128 * 128
    a1 = fused_args(x_b1, 5000)
    ms = statistics.median(event_ms(lambda: K.fused_run(*a1, **kw1), 1) for _ in range(3))
    plain_ms = event_ms(lambda: K.fused_run_plain(*a1, **kw1), 1)
    b = bound(5 * n1 * 4, RUN_FLOPS_PER_CELL * n1 * 5000)
    rows.append(dict(name="fused_run", shape="128x128x64, 5000 steps",
                     source="dccrg_tpu_torch/csrc/dense_advection.cu",
                     replaces="dccrg_tpu/ops/dense_advection.py:325", ms=ms,
                     plain_ms=plain_ms, bound=b))
    n2 = 128 * 512 * 512
    a2 = blocked_args(x_b2)
    ms = event_ms(lambda: K.flux_update_blocked(*a2, **kw2), 20)
    plain_ms = event_ms(lambda: K.flux_update_blocked_plain(*a2, **kw2), 3)
    b = bound(5 * n2 * 4 + 4 * 512 * 512 * 4, STEP_FLOPS_PER_CELL * n2)
    rows.append(dict(name="flux_update_blocked", shape="512x512x128, B=4, one step",
                     source="dccrg_tpu_torch/csrc/dense_advection.cu",
                     replaces="dccrg_tpu/ops/dense_advection.py:200", ms=ms,
                     plain_ms=plain_ms, bound=b))
    n3 = 63 * 128 * 128
    a3 = plane_args(x_b3)
    ms = event_ms(lambda: K.flux_update(*a3, **kw3), 50)
    plain_ms = event_ms(lambda: K.flux_update_plain(*a3, **kw3), 10)
    b = bound((3 * n3 + 2 * (63 + 2) * 128 * 128) * 4, STEP_FLOPS_PER_CELL * n3)
    rows.append(dict(name="flux_update", shape="128x128x63, one step",
                     source="dccrg_tpu_torch/csrc/dense_advection.cu",
                     replaces="dccrg_tpu/ops/dense_advection.py:86", ms=ms,
                     plain_ms=plain_ms, bound=b))
    n_vox = int(np.prod(adv_r._flat_run.shape))
    a5, kw5 = flat_args(adv_r, s_r, 2000, dt_r)
    ms = statistics.median(event_ms(lambda: F.flat_amr_run(*a5, **kw5), 1) for _ in range(3))
    plain_ms = event_ms(lambda: F.flat_amr_run_plain(*a5, **kw5), 1)
    # V, six weights and two masks in, V out; 2000 steps
    b = bound(10 * n_vox * 4, FLAT_AMR_FLOPS_PER_VOXEL * n_vox * 2000)
    rows.append(dict(name="flat_amr_run", shape="96^3 voxels (refined), 2000 steps",
                     source="dccrg_tpu_torch/csrc/flat_amr.cu",
                     replaces="dccrg_tpu/ops/flat_amr.py:299", ms=ms,
                     plain_ms=plain_ms, bound=b))
    n_vox = int(np.prod(adv_m._flat_run.shape))
    a6, kw6 = flat_args(adv_m, s_m, 1000, dt_m)
    ms = statistics.median(event_ms(lambda: F.flat_ml_run(*a6, **kw6), 1) for _ in range(3))
    plain_ms = event_ms(lambda: F.flat_ml_run_plain(*a6, **kw6), 1)
    cap_active = kw6["cap_active"]
    n_caps = 1 + max(k for k, on in enumerate(cap_active) if on)
    # V, six weights, updf, pool and the capture masks in, V out
    b = bound((10 + n_caps) * n_vox * 4,
              flat_ml_flops_per_voxel(cap_active) * n_vox * 1000)
    rows.append(dict(name="flat_ml_run", shape="64^3 voxels (refined3), 1000 steps",
                     source="dccrg_tpu_torch/csrc/flat_amr.cu",
                     replaces="dccrg_tpu/ops/flat_amr.py:1026", ms=ms,
                     plain_ms=plain_ms, bound=b))
    n_g = 500 * 500
    a4 = (board, 20000, False, False)
    ms = statistics.median(event_ms(lambda: G.gol_run(*a4), 1) for _ in range(3))
    plain_ms = event_ms(lambda: G.gol_run_plain(*a4), 1)
    # the board in, the board and the counts out; 20000 turns
    b = bound(3 * n_g * 4, GOL_OPS_PER_CELL * n_g * 20000)
    rows.append(dict(name="gol_run", shape="500x500, 20000 turns",
                     source="dccrg_tpu_torch/csrc/gol.cu",
                     replaces="dccrg_tpu/ops/gol_kernel.py:36", ms=ms,
                     plain_ms=plain_ms, bound=b))
    a7, kw7 = vlasov_args(1, (True, True, True), 21)
    n7, plane7 = 32 * 32 * 32 * 512, 32 * 32 * 512
    ms = event_ms(lambda: V.vlasov_step(*a7, **kw7), 50)
    plain_ms = event_ms(lambda: V.vlasov_step_blocked_plain(*a7, **kw7), 3)
    # f in and out (the edge planes are f's, read from the slab ring) and
    # the bin velocities in; the edge planes' xy splits are 10 operations a
    # cell
    b = bound((2 * n7 + 3 * 512) * 4,
              VLASOV_FLOPS_PER_CELL * n7 + 2 * 10 * plane7)
    rows.append(dict(name="vlasov_step", shape="32^3 x 512 bins, block 4, one step",
                     source="dccrg_tpu_torch/csrc/vlasov.cu",
                     replaces="dccrg_tpu/ops/vlasov_kernel.py:52", ms=ms,
                     plain_ms=plain_ms, bound=b))
    # B8: 14 voxel arrays in, the solution out; 60 iterations
    for p, s, shape in ((p_p, s_p, "64^3 voxels (poisson), 60 iterations"),
                        (p_pu, s_pu, "64^3 voxels (poisson_uniform), 60 iterations")):
        a8 = (*p._bicg_inputs(s), 60, 0.0, inf)
        kw8 = {"has_coarse": p._bicg_has_coarse}
        n_vox = a8[0].numel()
        ms = statistics.median(event_ms(lambda: B.bicg_solve(*a8, **kw8), 1)
                               for _ in range(3))
        plain_ms = event_ms(lambda: B.bicg_solve_plain(*a8, **kw8), 1)
        ops = BICG_FLOPS_PER_VOXEL + (BICG_COARSE_FLOPS_PER_VOXEL if kw8["has_coarse"] else 0)
        b = bound(15 * n_vox * 4, ops * n_vox * 60)
        rows.append(dict(name="bicg_solve", shape=shape,
                         source="dccrg_tpu_torch/csrc/poisson.cu",
                         replaces="dccrg_tpu/ops/poisson_kernel.py:52", ms=ms,
                         plain_ms=plain_ms, bound=b))
    # B9 at two main-path shapes: the split_advection density exchange (f32,
    # 4 bytes a row) and the split_vlasov f exchange (512 f32, 2 KiB a row);
    # rows read once and written once, plus the int32 index a row.  The
    # timed launches take turns over copies of the field that together
    # exceed twice the 50 MB L2, so each reads its rows from device memory
    # as the bound counts them; the time with one field, its rows
    # L2-resident after the first launch, is logged beside it.
    for x, ex, shape in ((s_sa["density"], ex_sa, "split_advection density, f32 scalar"),
                         (s_sv["f"], g_sv.halo(), "split_vlasov f, 512 f32 a row")):
        idx = ex._rings.send
        copies = [x.clone() for _ in range(-(-(128 << 20) // (x.numel() * x.element_size())))]
        flats = [c.flatten(0, 1) for c in copies]
        turn = iter(range(1 << 30))

        def cold(fn, src):
            return lambda: fn(src[next(turn) % len(src)])

        ms = event_ms(cold(lambda c: H.ring_gather([(c, idx)]), copies), 200)
        plain_ms = event_ms(cold(lambda c: H.ring_gather_plain([(c, idx)]), copies), 200)
        library_ms = event_ms(cold(lambda c: torch.index_select(c, 0, idx), flats), 200)
        warm_ms = event_ms(lambda: H.ring_gather([(x, idx)]), 200)
        log(f"[timing] ring_copy at {shape}: {warm_ms!r} ms with its rows in L2 "
            f"(one field, {len(copies)} copies for the cold times) on {card}")
        del copies, flats
        row_bytes = x[0, 0].numel() * x.element_size()
        b = bound(idx.numel() * (2 * row_bytes + 4), 0)
        rows.append(dict(name="ring_copy", shape=f"{shape}, {idx.numel()} rows",
                         source="dccrg_tpu_torch/csrc/halo_dma.cu",
                         replaces="dccrg_tpu/parallel/halo_dma.py:151", ms=ms,
                         plain_ms=plain_ms, bound=b, library_ms=library_ms))
    # B9's merge at the main-path shapes that take one (split_advection's
    # density, split_gol's alive field; a step's second launch): a payload's
    # rows into the refreshed ghost rows of all D*R rows, over copies of the
    # field that exceed the L2, beside its byte bound (each of the D*R
    # output rows read once, from the field or the payload, and written
    # once, plus its table entry)
    rings_g8 = gol8._exchange._rings_for_field("is_alive")
    for x, rings, shape in ((s_sa["density"], ex_sa._rings, "split_advection density, f32"),
                            (s_g8["is_alive"], rings_g8, "split_gol is_alive, uint32")):
        pay, = H.ring_gather([(x, rings.send)])
        copies = [x.clone() for _ in range(-(-(128 << 20) // (x.numel() * x.element_size())))]
        turn_m = iter(range(1 << 30))
        merge_ms = event_ms(lambda: H.ring_gather(
            [(copies[next(turn_m) % len(copies)], rings.merge, pay)]), 200)
        del copies
        n_rows = rings.merge.numel()
        bm = bound(n_rows * (2 * x[0, 0].numel() * x.element_size() + 4), 0)
        log(f"[timing] ring_gather merge at {shape} ({n_rows} rows, {pay.shape[0]} payload "
            f"rows): {merge_ms!r} ms a launch over copies of the field; bound {bm[0]!r} ms "
            f"({bm[1]}), kernel/bound {merge_ms / bm[0]!r} on {card}")
    # the grouped blocking exchange of the three-field state (one launch
    # through HaloExchange), over copies of the state that exceed the L2,
    # beside its byte bound (each field's rows read and written once, its
    # table entry a row), and the launch floor: an empty kernel on B9's
    # density grid in the same harness
    probe = ctypes.CDLL(str(probe_lib))
    probe.empty_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    size9 = sum(x.numel() * x.element_size() for x in s9.values())
    states = [{k: x.clone() for k, x in s9.items()} for _ in range(-(-(128 << 20) // size9))]
    turn9 = iter(range(1 << 30))
    K.reset_counts()
    ex_ms = event_ms(lambda: ex_sa(states[next(turn9) % len(states)]), 200)
    check(K.LAUNCHES["ring_copy"] == 201, f"grouped exchange: {K.LAUNCHES['ring_copy']} "
          f"launches for 201 exchanges")
    rows9 = ex_sa.D * ex_sa.R
    b9 = bound(sum(rows9 * (2 * x[0, 0].numel() * x.element_size() + 4)
                   for x in s9.values()), 0)
    warm9 = event_ms(lambda: ex_sa(s9), 200)
    plan9 = H.ring_gather_plan([(x, ex_sa._rings.full) for x in s9.values()])
    dens = s_sa["density"]
    ctas9 = H.ring_gather_plan([(dens, ex_sa._rings.send)])[0]["ctas"]

    def empty():
        check(probe.empty_launch(ctas9, 256, torch.cuda.current_stream().cuda_stream) == 0,
              "empty kernel: launch failed")
    empty_ms = event_ms(empty, 200)
    log(f"[timing] ring_gather grouped blocking exchange of the three fields ({rows9} rows "
        f"a field, 8 + 12 + 4 bytes a row): {ex_ms!r} ms, one launch, over copies of the "
        f"state ({warm9!r} ms L2-resident); bound {b9[0]!r} ms ({b9[1]}), kernel/bound "
        f"{ex_ms / b9[0]!r}; plan {plan9} on {card}")
    log(f"[timing] empty kernel of {ctas9} CTAs of 256 threads (B9's grid at the density "
        f"payload): {empty_ms!r} ms a launch, the floor beside ring_copy on {card}")
    del states
    # the on-chip plans of B1 and B4 at their main-path shapes, their
    # registers, and the bare grid barrier on each kernel's grid: what a
    # step of B1 and a round of B4 pay to synchronise
    p1 = K.fused_run_plan(64, 128, 128, *limits)
    p4 = G.gol_run_plan(500, 500, *limits)
    log(f"[timing] fused_run plan at 128x128x64: {p1.parts} bricks (z, y, x) of at "
        f"most {p1.tile} cells, {p1.ctas} CTAs of {p1.threads} threads, "
        f"{p1.smem_bytes} bytes of shared memory a CTA; registers "
        + ptxas_registers(built.get("dense_advection", {}).get("ptxas", ""),
                          "dense_fused_run_kernel"))
    log(f"[timing] gol_run plan at 500x500: {p4.parts} tiles (y, x) of at most "
        f"{p4.tile} cells, k = {p4.turns_per_round} turns a round, {p4.ctas} CTAs "
        f"of {p4.threads} threads, {p4.smem_bytes} bytes of shared memory a CTA; "
        "registers " + ptxas_registers(built.get("gol", {}).get("ptxas", ""),
                                       "gol_run_kernel"))
    probe.barrier_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def barriers(plan, n):
        err = probe.barrier_probe(plan.ctas, *plan.threads, n,
                                  torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"barrier probe: cudaError_t {err}")

    n4 = 20000 // p4.turns_per_round
    t1 = statistics.median(event_ms(lambda: barriers(p1, 5000), 1) for _ in range(3))
    t4 = statistics.median(event_ms(lambda: barriers(p4, n4), 1) for _ in range(3))
    log(f"[timing] bare grid barrier (median of 3, CUDA events): x5000 on B1's grid "
        f"{t1!r} ms ({1e3 * t1 / 5000!r} us each); x{n4} on B4's grid (one a round "
        f"of 20000 turns) {t4!r} ms ({1e3 * t4 / n4!r} us each) on {card}")
    # the on-chip plans of B5 and B6 at their main-path shapes and the
    # largest admitted grids, the registers of the instantiations they run,
    # and the bare barrier on their grids and on the grid of the streaming
    # B6 they replace (one 64-thread CTA a 4-cube: 4,096 at 64^3)
    flat_ptxas = built.get("flat_amr", {}).get("ptxas", "")
    for label, plan, kern in (
            ("flat_amr_run at 96^3", p96, "flat_amr_run_kernel"),
            ("flat_amr_run at 110x110x114", F.flat_amr_run_plan(*n_big, *limits),
             "flat_amr_run_kernel"),
            ("flat_ml_run at 64^3, kmax 1", p64, "flat_ml_run_kernel"),
            ("flat_ml_run at 104x108x112, kmax 1", F.flat_ml_run_plan(*m_big, 1, *limits),
             "flat_ml_run_kernel")):
        inst = f"{kern}ILi{plan.units_per_thread}ELb{int(plan.weights_on_chip)}E"
        log(f"[timing] {label} plan: {plan.parts} bricks (z, y, x) of at most "
            f"{plan.tile} voxels, {plan.ctas} CTAs of {plan.threads} threads, "
            f"{plan.units_per_thread} 2x2x2 units a thread, {plan.smem_bytes} bytes "
            f"of shared memory a CTA; shared memory holds {', '.join(plan.shared)}; "
            f"registers {', '.join(plan.registers)}; L2 "
            f"{', '.join(plan.l2) or 'nothing'}; ptxas {ptxas_registers(flat_ptxas, inst)}")
    for label, ctas, threads, n in (("B5's grid", p96.ctas, p96.threads, 2000),
                                    ("B6's grid", p64.ctas, p64.threads, 1000),
                                    ("the streaming B6's grid", 4096, 64, 1000)):
        grid = types.SimpleNamespace(ctas=ctas, threads=(threads, 1))
        t_bar = statistics.median(event_ms(lambda: barriers(grid, n), 1) for _ in range(3))
        log(f"[timing] bare grid barrier x{n} on {label} ({ctas} CTAs of {threads} "
            f"threads): {t_bar!r} ms ({1e3 * t_bar / n!r} us each; median of 3) on {card}")

    # the plans of B7 and B8 at their main-path shapes (and B8's l2 form at
    # the largest admitted grid), the registers of the instantiations they
    # run, and the bare barrier on B8's grid: what an iteration's two
    # barriers cost
    pv = V.vlasov_step_plan(1, 32, 32, 32, 512, *limits)
    log(f"[timing] vlasov_step plan at 32^3 x 512: {pv.tiles} tiles (y, x) of at most "
        f"{pv.tile} cells, {pv.chunks} chunks of {pv.chunk} bins, {pv.z_parts} z runs, "
        f"{pv.ctas} CTAs of {pv.threads} threads, {pv.vec}-float copies, {pv.smem_bytes} "
        f"bytes of shared memory a CTA; shared memory holds {', '.join(pv.shared)}; "
        f"registers {', '.join(pv.registers)}; ptxas "
        + ptxas_registers(built.get("vlasov", {}).get("ptxas", ""),
                          f"vlasov_tile_kernelILi{pv.vec}E"))
    bicg_ptxas = built.get("poisson", {}).get("ptxas", "")
    for label, shape, hc in (("poisson, 64^3 voxels", (64, 64, 64), 1),
                             ("poisson_uniform, 64^3 voxels", (64, 64, 64), 0),
                             ("100x98x98, coarse rows", (100, 98, 98), 1)):
        plan = B.bicg_solve_plan(*shape, bool(hc), *limits)
        inst = f"bicg_{plan.form}_kernelILb{hc}E"
        log(f"[timing] bicg_solve plan at {label}: form {plan.form}, {plan.ctas} CTAs of "
            f"{plan.threads} threads, {plan.tiles_per_cta} tiles a CTA"
            + (f", bricks of {plan.brick} voxels (tiles of {plan.tile_shape} items), "
               f"{plan.voxels_per_thread} voxels a thread" if plan.form == "box" else "")
            + f", {plan.smem_bytes} bytes of shared memory a CTA; shared memory holds "
            f"{', '.join(plan.shared) or 'the reductions only'}; registers "
            f"{', '.join(plan.registers) or 'nothing held'}; L2 {', '.join(plan.l2)}; "
            f"ptxas {ptxas_registers(bicg_ptxas, inst)}")
    p8u = B.bicg_solve_plan(64, 64, 64, False, *limits)
    grid8 = types.SimpleNamespace(ctas=p8u.ctas, threads=(p8u.threads, 1))
    t_bar = statistics.median(event_ms(lambda: barriers(grid8, 120), 1) for _ in range(3))
    log(f"[timing] bare grid barrier x120 (two an iteration, 60 iterations) on B8's grid "
        f"({grid8.ctas} CTAs of {p8u.threads} threads): {t_bar!r} ms ({1e3 * t_bar / 120!r} "
        f"us each; median of 3) on {card}")

    # ------------------------------------------------------- 21. balance
    # phase 17's refined grid on 8 slots: 20 gather steps, the refined cells
    # weighted 2, balance_load under HSFC, remap_state, a ghost refresh, 20
    # more steps; against 40 steps without the balance, by cell id
    cells_b = g_sa.get_cells()
    refined_b = cells_b[g_sa.mapping.get_refinement_level(cells_b) == 1]
    def gather_model(g):
        return Advection(g, dtype=np.float32, allow_dense=False, use_kernels=False)

    adv_ref = gather_model(g_sa)
    s_b = adv_ref.initialize_state()
    dt_b = 0.4 * adv_ref.max_time_step(s_b)
    ref40 = g_sa.get_cell_data(adv_ref.run(s_b, 40, dt_b), "density", cells_b)
    g_w = g_sa.copy_structure()
    t = time.perf_counter()
    for c in refined_b:
        g_w.set_cell_weight(int(c), 2.0)
    log(f"[balance] {len(refined_b)} refined cells of {len(cells_b)} weighted 2 in "
        f"{time.perf_counter() - t:.2f} s")

    def weighted_imbalance(g):
        w = np.ones(len(g.leaves))
        w[g.leaves.position(refined_b)] = 2.0
        load = np.bincount(g.leaves.owner, weights=w, minlength=g.n_devices)
        return float(load.max() / load.mean())

    def across_balance(staged):
        """20 steps, the balance (one-shot or staged in chunks of 20,000
        cells), the ghost refresh, 20 steps on a copy of the weighted grid;
        returns (grid, state after 40 steps, balance host seconds)."""
        g = g_w.copy_structure()
        g.set_partitioning_option("LB_METHOD", "HSFC")
        a = gather_model(g)
        st = a.run(s_b, 20, dt_b)
        sync()
        t = time.perf_counter()
        if staged:
            g.initialize_balance_load()
            while g.continue_balance_load(st, max_cells=20_000):
                pass
            st = g.finish_balance_load()
        else:
            g.balance_load()
            st = g.remap_state(st)
        sync()
        secs = time.perf_counter() - t
        st = g.update_copies_of_remote_neighbors(st)
        a = gather_model(g)
        return g, a, a.run(st, 20, dt_b), secs

    # 40 eager steps (one B9 launch each) and the refresh (one launch for
    # all six fields)
    g_one, a_one, out_one, secs_one = drive("balance", lambda: across_balance(False),
                                            {"ring_copy": 41})
    moved = int((g_one.leaves.owner != g_w.leaves.owner).sum())
    check(moved > 0, "balance: no cell moved")
    got = g_one.get_cell_data(out_one, "density", cells_b)
    check(np.array_equal(got.view(np.uint32), ref40.view(np.uint32)),
          f"balance: 40 steps across the balance != 40 without, max abs diff "
          f"{np.abs(got - ref40).max()!r}")
    m_ref = adv_ref.total_mass(s_b)
    m_one = a_one.total_mass(out_one)
    check(abs(m_one - m_ref) / m_ref <= 1e-5, f"balance: mass {m_ref} -> {m_one}")
    log(f"[balance] HSFC moved {moved} of {len(cells_b)} cells; weighted imbalance "
        f"(max / mean slot load) {weighted_imbalance(g_w)!r} -> "
        f"{weighted_imbalance(g_one)!r}; balance_load + remap_state {secs_one!r} s; 40 steps "
        f"across it bitwise equal by cell id to 40 without; mass {m_ref!r} -> {m_one!r}")
    g_stg, a_stg, out_stg, secs_stg = drive("balance staged", lambda: across_balance(True),
                                            {"ring_copy": 41})
    check(np.array_equal(g_stg.leaves.owner, g_one.leaves.owner), "staged: other owners")
    check(same_bits(out_stg["density"], out_one["density"])
          and all(same_bits(out_stg[k], out_one[k]) for k in out_one),
          "balance staged: != the one-shot balance")
    log(f"[balance staged] chunks of 20,000 cells: initialize + continue + finish "
        f"{secs_stg!r} s; the state after 40 steps bitwise equal to the one-shot form's")
    del a_one, out_one, a_stg, out_stg, g_stg
    # the board's uint32 state staged in chunks of 50,000 cells on 8 slots
    # (unsigned rows move through their signed view): every cell keeps its
    # value, as after the one-shot balance_load + remap_state
    g_gb = (Grid().set_initial_length((RES_BOARD, RES_BOARD, 1))
            .set_neighborhood_length(1).initialize(n_devices=8))
    cells_gb = g_gb.get_cells()
    s_gb = GameOfLife(g_gb, allow_dense=False).new_state(
        alive_cells=cells_gb[np.random.default_rng(0).random(len(cells_gb)) < 0.3])
    alive_gb = g_gb.get_cell_data(s_gb, "is_alive", cells_gb)
    owner_gb = g_gb.leaves.owner.copy()
    g_one_gb = g_gb.copy_structure()
    for g in (g_gb, g_one_gb):
        for c in cells_gb[: len(cells_gb) // 8]:
            g.set_cell_weight(int(c), 4.0)
    t = time.perf_counter()
    g_gb.initialize_balance_load()
    chunks = 1
    while g_gb.continue_balance_load(s_gb, max_cells=50_000):
        chunks += 1
    out_gb = g_gb.finish_balance_load()
    sync()
    secs = time.perf_counter() - t
    g_one_gb.balance_load()
    one_gb = g_one_gb.remap_state(s_gb)
    check(out_gb["is_alive"].dtype == torch.uint32
          and np.array_equal(g_gb.get_cell_data(out_gb, "is_alive", cells_gb), alive_gb)
          and np.array_equal(g_gb.leaves.owner, g_one_gb.leaves.owner)
          and np.array_equal(g_gb.get_cell_data(out_gb, "is_alive", cells_gb),
                             g_one_gb.get_cell_data(one_gb, "is_alive", cells_gb)),
          "balance staged board: the uint32 state changed in the migration")
    log(f"[balance staged] the {RES_BOARD}x{RES_BOARD} board's uint32 state in {chunks} "
        f"chunks of 50,000 cells, {int((g_gb.leaves.owner != owner_gb).sum())} cells "
        f"moved: {secs!r} s, every cell's value kept, equal to the one-shot form's on {card}")
    del g_gb, g_one_gb, s_gb, out_gb, one_gb
    # the host seconds of balance_load alone, from the weighted grid, with the
    # incremental rebuild and with DCCRG_EPOCH_DELTA=0
    for method in ("HSFC", "RCB", "GRAPH"):
        for delta_on in (True, False):
            g = g_w.copy_structure()
            g.set_partitioning_option("LB_METHOD", method)
            g._compute_new_owner = timed("partition", g._compute_new_owner)
            if not delta_on:
                os.environ["DCCRG_EPOCH_DELTA"] = "0"
            c0 = counters("epoch.delta")
            t = time.perf_counter()
            g.balance_load()
            secs = time.perf_counter() - t
            os.environ.pop("DCCRG_EPOCH_DELTA", None)
            how = [k for k, v in counters("epoch.delta").items() if v != c0.get(k, 0)
                   and "{" in k]
            moved = int((g.leaves.owner != g_w.leaves.owner).sum())
            log(f"[balance] {method}, {'incremental rebuild' if delta_on else 'DCCRG_EPOCH_DELTA=0'}"
                f": balance_load {secs!r} s host, the partitioner {split.pop('partition')!r} of "
                f"it (epoch: {how or 'full build'}); "
                f"{moved} cells moved; weighted imbalance {weighted_imbalance(g_w)!r} -> "
                f"{weighted_imbalance(g)!r} on {card}")
            del g
    # a small repartition from the balanced layout (every 100th cell pinned
    # to the next slot): the kind of move the incremental rebuild patches
    sel = cells_b[::100]
    for delta_on in (True, False):
        g = g_one.copy_structure()
        for c, d in zip(sel, g.get_owner(sel)):
            g.pin(int(c), (int(d) + 1) % g.n_devices)
        g._compute_new_owner = timed("partition", g._compute_new_owner)
        if not delta_on:
            os.environ["DCCRG_EPOCH_DELTA"] = "0"
        c0 = counters("epoch.delta")
        t = time.perf_counter()
        g.balance_load()
        secs = time.perf_counter() - t
        os.environ.pop("DCCRG_EPOCH_DELTA", None)
        how = [k for k, v in counters("epoch.delta").items() if v != c0.get(k, 0)
               and "{" in k]
        log(f"[balance] {len(sel)} cells pinned to the next slot after the HSFC balance, "
            f"{'incremental rebuild' if delta_on else 'DCCRG_EPOCH_DELTA=0'}: balance_load "
            f"{secs!r} s host, the partitioner {split.pop('partition')!r} of it (epoch: "
            f"{how or 'full build'}); "
            f"{int((g.leaves.owner != g_one.leaves.owner).sum())} cells moved on {card}")
        del g
    del g_w, g_one, adv_ref

    # -------------------------------------------------------------- 22. pic
    def cell_order(pc, state):
        """(count per cell, coordinates per cell in slot order) over the
        leaves in id order, on the host."""
        g = pc.grid
        pos = g.leaves.position(g.get_cells())
        d, r = g.leaves.owner[pos], g.epoch.row_of[pos]
        cnt = state["number_of_particles"].cpu().numpy()[d, r]
        xyz = state["particles"].cpu().numpy()[d, r]
        xyz[np.arange(pc.P)[None, :] >= cnt[:, None]] = 0
        return cnt, xyz

    def cell_sets(pc, state):
        """Counts per cell and each cell's particles sorted by coordinates:
        the per-cell comparison where slot order depends on the layout."""
        cnt, xyz = cell_order(pc, state)
        n = len(cnt)
        live = np.arange(pc.P)[None, :] < cnt[:, None]
        cell = np.repeat(np.arange(n), cnt)
        p = xyz[live]
        order = np.lexsort((p[:, 2], p[:, 1], p[:, 0], cell))
        return cnt, p[order]

    def pic_phase(label, pc, pts, vel, dt, n, expect):
        s0 = pc.new_state(pts)
        check(pc._dev_rebucket is not None, f"{label}: the device re-bucket did not engage")
        pc.run(s0, 2, velocity=vel, dt=dt)         # warm-up
        out = drive(label, lambda: pc.run(s0, 50, velocity=vel, dt=dt), expect)
        check(pc.count(out) == n, f"{label}: {pc.count(out)} particles, expected {n}")
        check(int(out["overflow"]) == 0, f"{label}: {int(out['overflow'])} dropped")
        check(bool(torch.isfinite(out["particles"]).all()), f"{label}: non-finite")
        # 5 steps on the device re-bucket against the host re-bucket
        host = Particles(pc.grid, max_particles_per_cell=pc.P, dtype=pc.dtype)
        host._dev_rebucket = None
        t = time.perf_counter()
        hs = host.run(s0, 5, velocity=vel, dt=dt)
        host_s = time.perf_counter() - t
        ds = pc.run(s0, 5, velocity=vel, dt=dt)
        same = cell_order if pc.grid.n_devices == 1 else cell_sets
        (cd, xd), (ch, xh) = same(pc, ds), same(host, hs)
        check(np.array_equal(cd, ch) and np.array_equal(xd.view(np.uint32), xh.view(np.uint32)),
              f"{label}: 5 device re-bucket steps != 5 host steps")
        log(f"[{label}] {n} particles, P = {pc.P}, {len(pc.grid.get_cells())} leaves on "
            f"{pc.grid.n_devices} slot(s): run(50) keeps all, none dropped; 5 steps bitwise "
            f"equal to the host re-bucket ({'slot order' if same is cell_order else 'per cell, sorted'}"
            f"; the host path {host_s / 5!r} s a step)")
        rate(label, lambda: pc.run(s0, 50, velocity=vel, dt=dt), n, 50,
             unit="pushes/s including migration")
        return s0, out

    t = time.perf_counter()
    pc_u, pts_u, vel_u = pic_setup(PIC_N, PIC_GRID)
    log(f"[pic] grid + model (P = {pc_u.P}) in {time.perf_counter() - t:.2f} s")
    pic_phase("pic", pc_u, pts_u, vel_u, 0.2 / PIC_GRID, PIC_N, {})
    del pc_u, pts_u

    # --------------------------------------------------- 23. pic_refined_lb
    # phase 2's refined, HSFC-balanced particle model on 8 slots: two B9
    # launches a step (counts, then coordinates)
    dt_lb = 0.1 / PIC_REFINED_GRID
    s_lb, out_lb = pic_phase("pic_refined_lb", pc_lb, pts_lb, vel_lb, dt_lb,
                             PIC_REFINED_N, {"ring_copy": 100})
    # the unbalanced 8-slot run of the same particles: each cell's particles
    # equal (as sets: slot order follows the layout)
    pc_nb, _p, vel_nb = pic_setup(PIC_REFINED_N, PIC_REFINED_GRID, max_ref=1,
                                  refine_ball=0.25, seed=1, n_devices=8)
    check(not np.array_equal(pc_nb.grid.leaves.owner, pc_lb.grid.leaves.owner),
          "pic_refined_lb: the balance moved nothing")
    out_nb = pc_nb.run(pc_nb.new_state(pts_lb), 50, velocity=vel_nb, dt=dt_lb)
    (c1, x1), (c2, x2) = cell_sets(pc_lb, out_lb), cell_sets(pc_nb, out_nb)
    check(np.array_equal(c1, c2) and np.array_equal(x1.view(np.uint32), x2.view(np.uint32)),
          "pic_refined_lb: particles per cell != the unbalanced 8-slot run's")
    log("[pic_refined_lb] run(50): each cell's particles bitwise equal to the unbalanced "
        "8-slot run's")
    # B9 at the particle state's row widths: its counts and its P x 3 f32 rows
    ex_lb = pc_lb._exchange
    for field in ("number_of_particles", "particles"):
        x = out_lb[field]
        idx = ex_lb._rings.send
        copies = [x.clone() for _ in range(-(-(128 << 20) // (x.numel() * x.element_size())))]
        turn_p = iter(range(1 << 30))
        ms = event_ms(lambda: H.ring_gather([(copies[next(turn_p) % len(copies)], idx)]), 200)
        plain_ms = event_ms(lambda: H.ring_gather_plain([(x, idx)]), 50)
        lib_ms = event_ms(lambda: torch.index_select(x.flatten(0, 1), 0, idx), 200)
        del copies
        row_bytes = x[0, 0].numel() * x.element_size()
        b = bound(idx.numel() * (2 * row_bytes + 4), 0)
        log(f"[timing] ring_copy at pic_refined_lb {field} ({row_bytes} bytes a row, "
            f"{idx.numel()} rows): kernel {ms!r} ms over copies of the field, twin "
            f"{plain_ms!r} ms, torch.index_select {lib_ms!r} ms, bound {b[0]!r} ms ({b[1]}), "
            f"kernel/bound {ms / b[0]!r} on {card}")

    # 28. c1: the refined and refined3 grids at neighbourhood length 1, where
    # a fine cell lists a coarse face neighbour once for every offset it
    # covers: 200 gather steps keep mass, and the flat kernels' run equals
    # the gather step
    for label, n, radii, center, max_ref, kname in (
            ("refined", 48, (0.3,), (0.3, 0.5, 0.5), 1, "flat_amr_run"),
            ("refined3", 16, (0.6, 0.55), (0.5, 0.5, 0.5), 2, "flat_ml_run")):
        t = time.perf_counter()
        g_c = refined_grid(n, radii, center, max_ref, hood=1)
        # one model: step is the gather step, run the flat kernel
        adv_c = Advection(g_c, dtype=np.float32, allow_dense=False)
        check(adv_c._flat_kind == ("pallas" if max_ref == 1 else "ml_pallas"),
              f"c1 {label}: dispatch {adv_c._flat_kind}")
        s_c = adv_c.initialize_state()
        dt_c = 0.4 * adv_c.max_time_step(s_c)
        log(f"[c1 {label}] grid at neighbourhood length 1 ({len(g_c.get_cells())} leaves) "
            f"+ models + state in {time.perf_counter() - t:.2f} s")

        def gather_c(model, n=200):
            st = s_c
            for _ in range(n):
                st = model.step(st, dt_c)
            return st

        out_g = drive(f"c1 {label} gather", lambda: gather_c(adv_c), {})
        finite_mass(f"c1 {label} gather", adv_c, s_c, out_g, 1e-5)
        out_f = drive(f"c1 {label} flat", lambda: adv_c.run(s_c, 200, dt_c), {kname: 1})
        loc = adv_c.tables.local_mask
        rel = float((out_f["density"] - out_g["density"])[loc].abs().max()
                    / out_g["density"][loc].abs().max())
        check(rel <= 1e-4, f"c1 {label}: run(200) vs 200 gather steps, rel err {rel:.3e}")
        # the classification before the repair, for the record: the same
        # model with every entry of a repeated coarse face priced
        keep = NB.first_faces
        NB.first_faces = lambda group, key: np.ones(len(key), dtype=bool)
        try:
            raw_c = copy.copy(adv_c)
            raw_c._dev = A_mod.build_face_tables(g_c, None, adv_c.tables, np.float32)[1]
        finally:
            NB.first_faces = keep
        st = gather_c(raw_c)
        m0 = adv_c.total_mass(s_c)
        log(f"[c1 {label}] 200 gather steps: relative mass drift "
            f"{abs(adv_c.total_mass(out_g) - m0) / m0!r} (limit 1e-5; with every repeated "
            f"entry priced, as before the repair: {abs(raw_c.total_mass(st) - m0) / m0!r}); "
            f"run(200) through {kname} vs the gather step: max err / max density {rel!r} "
            f"(limit 1e-4) on {card}")
        del g_c, adv_c, raw_c, s_c, out_g, out_f, st

    # 31. serve: cohorts on B2, B3, B7 and B9, the ensemble and wide-halo
    # sweeps, the fleet gateway
    serve_phase(dev, card, drive, g_sa, s_sa, adv_s, event_ms, bound)

    # 30. resilience: crash, resume and rescales of the headline, the board
    # rescaled and supervised through a hang, a NaN storm on phase 17's grid,
    # a torn generation
    resilience_phase(dev, card, drive, (g_sa, s_sa, adv_s.spec))

    # 32. spmd: the gather path on 2 controllers x 4 slots over gloo,
    # bitwise against one controller on 8 slots; 3 x 2; nccl where it can
    o32 = spmd_phase(dev, card)

    # 33. spmd serve and lineage: the split steps, the cohorts and the
    # lineage across controllers, each against one controller
    o33 = spmd_serve_phase(dev, card)

    # 34. ipc: phase 32's 2 x 4 run and phase 33's split cases and cohorts
    # over gloo and then over the device-direct transport, against the
    # oracles of 32 and 33; B9's remote write timed
    ipc_phase(dev, card, o32["one"], o33)

    kernels = []
    for r in rows:
        (b_ms, b_by) = r["bound"]
        lib = r.get("library_ms")
        log(f"[timing] {r['name']} at {r['shape']}: kernel {r['ms']!r} ms, twin "
            f"{r['plain_ms']!r} ms, "
            + ("" if lib is None else f"torch.index_select {lib!r} ms, ")
            + f"bound {b_ms!r} ms ({b_by}), "
            f"kernel/bound {r['ms'] / b_ms!r}, launches on the main path "
            f"{launches[r['name']]} on {card}")
        if any(k["name"] == r["name"] for k in kernels):
            continue  # one entry a kernel: its first-listed main-path shape
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": twin_err[r["name"]], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"),
        })

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def spmd_only(device="cuda") -> int:
    """``python3 chip_smoke.py --spmd-only [cpu]``: phases 32, 33 and 34
    alone (a quick check of the multi-controller paths; ``cpu`` rehearses
    them without a card)."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        o32 = spmd_phase(torch.device("cuda"), card)
        o33 = spmd_serve_phase(torch.device("cuda"), card)
        ipc_phase(torch.device("cuda"), card, o32["one"], o33)
    else:
        o32 = spmd_phase("cpu", "the CPU", device="cpu")
        o33 = spmd_serve_phase("cpu", "the CPU", device="cpu")
        ipc_phase("cpu", "the CPU", o32["one"], o33, device="cpu")
    log("[spmd] ok")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--spmd-only"]:
        sys.exit(spmd_only(*sys.argv[2:3]))
    sys.exit(main())
