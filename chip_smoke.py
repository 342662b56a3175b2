#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 1M spans, 5k operations,
                                     # a 6-window replay of 1M-span windows,
                                     # giant windows of 2M and 10M spans
    python3 chip_smoke.py --spans N --giant-spans M  # smaller, same shape of run
    python3 chip_smoke.py --giant-spans 0            # no giant phase
    python3 chip_smoke.py --replay-windows 0         # no replay phase

It drives only the port (``microrank_tpu_torch``) and imports nothing of
JAX or of the JAX package. Phases, one JSON line each:

1. env      — the card, its power limit, the kernels built from the
              sources in this checkout (nvcc for ``csrc/coo_spmv.cu``,
              ``csrc/pattern_pair.cu``, ``csrc/power_step.cu``,
              ``csrc/row_fold.cu``, ``csrc/rank_setup.cu``,
              ``csrc/rank_epilogue.cu``, ``csrc/dense_mv.cu``,
              ``csrc/csr_scan.cu`` and ``csrc/explain_epilogue.cu``, g++ for
              the native span loader / graph builder, all at once), the
              dense kernel (f32 and bf16, one window and three, an
              unaligned vector) and K14's check word (a block, a cluster,
              the first design; with a NaN and without) bitwise their
              plain versions, 0 bytes of spill in both (gates), the fixed-order fold on rows
              of one tile and of several, bitwise its plain version,
              K6's set-up (one tile beside two (a cluster) and beside
              ten (the grid form), collapsed or not, both preference
              forms, one window and three) and epilogue (300 ops and
              9,000 (a cluster of two), k of 11 and 40, every method,
              one window and three) bitwise their plain versions and
              the first designs' kernels on the card, a gate on 0 bytes
              of spill in every K6 kernel (``k6_ptxas``), and one tiny
              launch of K1 (a
              row of several chunks, empty rows, padding), of the pcsr
              step (that work list with ELL slabs of widths 4 and 1024,
              then 1 and 64: rows past 256 entries, empty rows) and of
              the pattern pair (f32, bf16 and int8 with its scale launch,
              and K8's kernel in f32; several tiles with ragged edges)
              and chains of three steps of the step kernel (K5: default,
              no normalization, a tol that freezes, an empty partition,
              the int8 scales, and windows at and past the register
              slots, through one window and through one-step calls; and
              K5's group kernel ``step_grid_group<S>`` over groups of 2
              to 4 windows: below, at and past the slots, held in shared
              memory or recomputed, a grid the units outnumber, a tol
              whose windows freeze at different steps, int8, also
              through PR 13's kernel) held bitwise against their plain
              versions; the step kernels' occupancy (blocks an SM,
              register slots) and every instantiation's ptxas lines,
              with a gate on 0 bytes of spill in every
              ``step_grid_group<S>``; and the two
              device timers (torch.profiler, CUDA events) on a 1 GiB
              device copy;
2. data     — one detection window at bench.py's config-5 scale
              (1,000,000 spans, 5,000 operations, 100 trace kinds,
              child_keep_prob 0.55, 60 s fault, seed 0) from the port's
              own generator;
3. run      — ``run_rca_native(..., device="cuda")`` with the pinned
              ``kernel="pallas"``, collapse_kinds "auto" and "off": top-1
              is the injected fault, K1 launches once per power-iteration
              step (25 per ranked window) and computes 2 partitions x 3
              SpMVs in each launch (150 per ranked window), the step
              kernel once per step (25 per ranked window, on every
              route below too), and the CUDA
              run agrees tie-aware (rtol 1e-5) with the same run on the
              CPU; on every route the window, staged once, is run again
              with the plain step (``power_step_plain``) on the card:
              weights, vectors, residual trace, n_iters and ranking
              bitwise; the rank
              program timed whole by CUDA events behind a device spin
              (``rank_program_event_ms``) beside the host's time to issue
              it (``rank_program_host_ms``);
4. run      — the same with the default ``kernel="auto"``: collapse
              "auto" resolves to ``kind`` (K2), "off" to ``packed_bf16``
              (K4). Per ranked window 25 pattern-pair launches and 25 K1
              launches of 2 SpMVs (the call-graph terms); tie-aware
              agreement with the CPU run at rtol 1e-5 (kind, f32) or
              5e-3 (packed_bf16), the same top-1 and n_iters; then, collapse
              "off", at two lowered dense budgets (64 MiB and 16 MiB at
              config 5; the two inequalities printed from the window's
              shapes): auto resolves to ``packed_blocked`` (25 launches of
              K8's own kernel and its 25 fold launches, and 25 K1 launches
              of 2 SpMVs per ranked window) and to
              ``pcsr`` (25 launches of the pcsr kernel, 6 SpMVs each, no
              K1 launch), CUDA vs CPU at rtol 1e-5, and pcsr's ranking
              bitwise the pinned pallas run's;
   int8     — the same window with ``kind_precision="int8"``, auto,
              collapse "on" (resolves to ``kind``): per ranked window one
              scale launch (``quantize_amax``, the first step's scales;
              the step kernel gives every later step's), 25 int8 pair
              launches and 25 K1 launches of 2 SpMVs; top-1 the fault; the top-5
              tie-aware against the CPU run at rtol 5e-2 (JAX's own int8
              gate), the same n_iters;
   policy   — a ``policy.json`` in the JAX package's schema for the
              window's workload profile (``method="ochiai"``) through
              ``MICRORANK_POLICY_DIR``: ``run_rca_native`` bitwise an
              explicit ochiai run, one "applied" policy event (every other
              phase runs with an empty policy directory);
   (every rank program, on every route, a stacked group as a
              whole: one launch of K6's set-up, ``csrc/rank_setup.cu``,
              and one of its epilogue, ``csrc/rank_epilogue.cu``, and
              none of the standalone fold, ``csrc/row_fold.cu``, whose
              tree runs inside both; every run line's ``k6``: both
              kernels bitwise their plain versions and the first
              designs' on the card and over 50 launches at its window,
              timed in turns with the first designs beside the plain
              versions, the bound and, for the top-k, a stable
              ``torch.sort``, with the form each launch planned; the
              same for the batched kind group of 6 and the giant
              windows)
   staging  — blob staging (the default: one pinned buffer a window, one
              copy, the leaves typed views of the device buffer, K7)
              against the tree path (``blob_staging=False``: a copy a
              leaf) on every config-5 route (kind f32 and int8, packed,
              packed_bf16, pallas collapsed and not, packed_blocked at
              64 MiB, pcsr at 16 MiB; ``staging_compare``): every leaf
              decoded on the card fetched back bitwise the host array,
              at a 256-byte-aligned address; in turns (tree, blob, blob,
              tree) the tree's H2D, the blob's pack (host clock) and copy
              (events), the outputs bitwise the tree path's with the
              same launches, and the stage worker's host time from the
              staging to the output copy while the device spins ~100 ms;
              on every route (pcsr and pallas too: their counts from
              the host graph, ``host_counts``, timed apart) the staging,
              layouts, program and output copy under
              ``set_sync_debug_mode("error")`` without a raise. The
              pack's first call (the pinned buffer's first allocation)
              is reported apart. The giant windows and their stacked
              groups get the same checks (``giant.staging``,
              ``giant.stacked.staging``);
5. replay   — ``TableRCA.run`` on the card over bench.py's config-5
              replay (``_run_replay``; its 8 windows cut to 6 so that the
              whole script keeps its time with the follow phase): 6
              consecutive windows of
              1,000,000 spans, every one faulted, from the port's
              ``generate_timeline_with_spans`` (same generator settings as
              phase 2), detect = the generator's window, skip 0; in five
              modes of the loop: sync (depth 1), the default (async stage
              and fetch workers, stream joins, depth 2), async bulk,
              ``chunked`` (bench.py's own: bulk joins,
              ``dispatch_batch_windows=4``, so groups of 4 and 2, each
              one stacked program), ``batch``
              (``run(batch_windows=True)``: one stacked program for all
              windows after the loop) and ``chunked_int8`` (``chunked``
              with ``kind_precision="int8"``: one scale launch a group,
              held to a per-window int8 run, tie-aware top-5 at 5e-2,
              bitwise reported), and ``tree`` (the default with
              ``blob_staging=False``, as ``--no-blob-staging``).
              Each mode: one warm pass with a sink (every window ranked
              with ``kind`` and the fault at top-1, the cursor cleared,
              one journal ``window`` event per window, the stage worker's
              stream not the default stream), three timed passes (median
              reported; 25 pattern-pair and 25 K1 launches of 50 SpMVs per
              ranked window in each) and one pass under torch.profiler for
              the device busy share (the union of kernel intervals over
              that pass's wall time); peak device memory, the
              per-window ``rank_dispatch`` / ``rank_wait`` medians and
              the sum of the per-window stages (the rest of a pass is
              per-run work, such as the table's admission, timed apart).
              The
              async, bulk and tree rankings, ``rank_iterations`` and sink
              records are bitwise the sync run's; the chunked and batch
              runs' the same windows, iterations and top-1, rankings
              tie-aware at rtol 1e-5 (bitwise reported), and their
              launches 25 of each kernel per group; a run resumed from
              a cursor saved after window 2 is bitwise windows 3-6. The
              default mode's warm pass records into a fresh metrics
              registry and writes ``metrics.json`` as ``cli run`` does:
              ranked windows, convergence samples, admitted rows and
              blob transfers (one a ranked window) as counted,
              ``telemetry`` in the journal's ``run_end``; every mode's
              warm pass counts one staging transfer a program (blob) or
              one a leaf (tree). The default and tree modes then run in
              turns (default, tree, tree, default): ms per window and
              the stage worker's host ms a window (``staging_turns``,
              three rounds: medians, and the pairs the default won); the
              default's warm pass gates its span ring (the spans
              recorded equal ``microrank_spans_recorded_total``, each in
              a ``win-<start>`` trace of the run), and the default runs
              with the span tracer on and off (``--no-span-trace``) in
              turns (on, off, off, on: ms per window, reported).
              ``--replay-windows`` sets the window count; 0 skips it;
   follow   — ``run_follow`` on the card over the same timeline written
              in three appends (the injected ``sleep`` appends the next
              part), ``idle_exit=1``: its rankings bitwise a sync
              ``TableRCA.run`` over the whole file; polls, windows and
              ms per poll;
   batched  — K18, the stacked rank program: the replay's config-5
              ``kind`` windows (each built by ``prepare_rank``) stacked in
              groups of B = 1, 2, 4 and 6 (``stack_window_graphs``), the
              same windows with ``kind_precision="int8"`` and ``"bf16"``
              at B = 2, 4 and 6, and the config-5 window stacked twice
              for ``pallas``,
              ``packed_bf16``, ``packed_blocked`` (the 64 MiB run's
              window) and ``pcsr`` (the 16 MiB run's). Each group: 25
              launches of each kernel of its route for the whole group
              (K1, the pair or K8 and its fold, the pcsr step, K5; int8
              one ``quantize_amax`` launch); each window's n_valid and
              n_iters those of its own program, its ranking tie-aware at
              rtol 1e-5 (int8: the top-5 at 5e-2; bitwise reported); the
              group through the plain step and PR 13's group kernel on
              the card bitwise; K6's two kernels at the group's shapes
              (the epilogue on its final carries) bitwise their plain
              versions and the first designs; K5's group kernel at the
              group's shapes
              over chains of 50 launches (default, a tol whose windows
              freeze at different steps, int8 with the group's scales)
              bitwise the plain step and PR 13's kernel
              (``group_step_check``); its
              window-axis kernels bitwise their plain versions (computed
              on the CPU; for packed_bf16 and packed_blocked the windows'
              own launches) and over 50 launches; every group's windows
              bitwise their own programs (a gate).
              The kind groups of 2, 4 and 6 and the int8 group of 6: a
              step split by kernel (``step_split``: the group's step
              timed in turns with PR 13's kernel, its grid plan
              printed). The kind groups and the int8 group of 6 timed in turns with the windows' own
              programs (windows, stacked, stacked, windows; each window's
              program timed alone and the B summed): host issue and
              device time by CUDA events behind a ~100 ms spin, the
              device drained after each call, per program and per
              window;
   quarantine — the replay's timeline poisoned from a seed (1% of the
              rows a negative duration, 0.1% an end before the start,
              5,000 rows moved into one trace past the 4,096-span cap)
              through ``TableRCA.run`` on the card with ``out_dir``:
              ``quarantine.jsonl``'s records per reason equal
              ``admit_table``'s counts, each parses and names a reason of
              ``REASONS``, none dropped at the 16 MiB cap, the run's
              launches those of its windows; at a 1 MiB cap records +
              dropped = the rejected rows; ``admit_table`` with the file
              store against the counting-only store in turns, and the
              file's bytes;
   families — the csr, coo and dense families (K10-K12) and the
              checked program (K14) on ``cli run``'s table lane at config
              5 (``phase_families``): ``run_rca_native`` with ``kernel``
              csr, coo, dense and dense_bf16, each collapsed ("auto",
              what ``--kernel X`` builds by default) and not ("off", the
              dense matrices in the gigabytes): top-1 the fault, 25 K1
              launches of 6 SpMVs (coo), 25 launches of K10's scan (csr:
              ``csr_scan_spmv``, JAX's order of sums, one cooperative
              launch of ``scan_step`` a step) or 25 dense launches
              of 6 products (dense) a ranked window, tie-aware agreement
              with the port's coo route on the CPU (rtol 1e-5; dense_bf16
              5e-3), coo bitwise the pinned pallas run, the
              window's stage times (``stage_ms.layouts`` holds the
              densify) and rank program by events, its staging to output
              copy under the sync check; the dense kernel bitwise its
              plain version on every launch of the window's 25 steps
              (``dense_step_check``) and timed (``measure_dense``: the
              plain version, six ``torch.mv`` and the byte bound; 50
              calls collapsed, 5 uncollapsed); K1 over the coo work list
              timed uncollapsed (``measure_group``); K10 over each
              window's CSR views (collapsed and not) bitwise its plain
              version on the CPU, the level passes and over 50 calls, one
              launch a call, timed in turns with the level passes and with
              K1 over the csr work list (K1's design) beside six CSR
              matvecs and the byte bound (``measure_csr_scan``); each
              family's stacked groups of the replay's windows (B = 2 and
              6) bitwise their windows' own programs in one window's
              launches (``family_stacks``); the replay with
              ``device_checks`` bitwise the sync replay, the config-5
              window with ``abnormal.sr_val[0]`` NaN raising
              ``DeviceCheckError`` ("non-finite") on coo and dense with no
              host sync, and the epilogue checked and unchecked in turns
              at the config-5 kind window, bitwise (``family_checks``);
   eval     — the accuracy harness (``evaluation``, ``cli eval``) on the
              card and again with ``device="cpu"`` (the plain versions),
              the reports equal field for field and case by case:
              ``evaluate`` at the JAX CLI's defaults (20 cases, 30
              operations, 400 traces, 48 kinds, keep-prob 0.15),
              ``evaluate_all_methods`` at EVALUATION.md's 13-formula
              setting (50 cases; one K13 launch a case, counted),
              ``evaluate_overlap_ablation`` (2 faults, 10 cases an
              overlap) and ``evaluate_detection`` (10 timelines); each
              card run's launches gated (one program a detected case, on
              the kernel its build resolved); R@k and both Exam Scores
              printed; then ``evaluate`` and ``evaluate_all_methods`` over
              2 cases at config-5 scale on the card (phase 2's
              configuration, seeds 0 and 1), each case's seconds split
              into generate / load / detect / build / rank program and the
              culprits' ranks (seed 0's at rank 1: a gate);
6. kernel   — K1 at the shapes of phases 3 and 4. Per matrix (groups of
              one, at the uncollapsed shapes), per step of the pallas
              path (the grouped launch of all six matrices, at the
              uncollapsed and the collapsed shapes) and per step of the
              auto path (the launch of both call-graph terms, for kind
              and packed_bf16): bitwise equal to its plain version computed on the
              CPU, bitwise repeatable over 50 launches with every arrival
              counter back at 0, and timed (CUDA events per call behind
              a device spin) beside the plain version, torch.sparse_csr_tensor matvecs (a
              yardstick the port never calls), the byte bound at
              3.35 TB/s, and the first, warp-per-row design of the kernel
              (``mr_coo_spmv_rows``), timed in turns with the chunked one
              (first, chunked, chunked, first); and the pcsr kernel's
              step at the shapes of its run (``measure_pcsr``: bitwise its
              plain version on the CPU, K1 over the earlier pcsr work
              list and the pallas work list of the same window, bitwise
              over 50 launches, rtol 1e-6 on the card; timed in turns
              with that earlier design and six cuSPARSE CSR matvecs by
              CUDA events per call behind a device spin (the kernel's
              own time), over back-to-back calls and by torch.profiler;
              and its two halves as launches of their own);
7. pattern  — K2 (f32 and bf16, at the collapsed shapes of phase 4;
              int8 at the int8 run's: the scale launch, then the pair,
              timed together and apart, its library yardstick
              ``torch._int_mm``) and K4 (packed and packed_bf16,
              uncollapsed): one step for both partitions, bitwise equal
              to its plain
              version computed on the CPU and within rtol 1e-6 of it run
              on the card, bitwise repeatable over 50 launches, equal
              rows and equal columns of a constructed pattern giving
              equal bits, and timed (CUDA events per call behind a
              device spin) beside the plain version, the pair of
              torch.matmul calls over the loop-invariant cast matrix
              (what JAX computes; a yardstick the port never calls) and
              the byte bound; K8's kernel the same at the packed_blocked
              run's window, also held bitwise to the tile kernel in f32 on
              the same inputs and timed in turns with it, its fwd
              partials bitwise their plain layout; plus a sweep of K4 over
              one-partition bitmaps of four shapes;
   step     — K5 at the config-5 ``kind`` window's shapes and the int8
              window's (``measure_step``): one step of the fused kernel
              bitwise its plain version on the card, chains of 25 steps
              through one window (25 launches) bitwise with the default
              configuration, a tol, an empty partition, no normalization
              and (int8) the fused scales; timed by CUDA events behind a
              spin in turns with the plain step (new, plain, plain, new)
              beside the byte bound and the host's issue
              time of a window's step call; the grid, blocks an SM and
              register slots; the kind window with a tol that stops it
              early, and a giant-tier window of 262,144 spans with its
              normal partition empty (NaN, and a tol run that stops
              after one step), bitwise the plain step; and the kind rank
              program's host issue split (``rank_issue_split``: the
              set-up before the loop, the 25 steps by wrapper, the
              epilogue; with K6's kernels and with their plain versions
              in turns), behind a spin; K6 at the kind window, fully
              timed (each kernel in turns with its first design, the SM
              cycles of its phases, a one-float fill as the floor of a
              launch timed this way) and the epilogue's seeded sweep
              (V of 8 to 65,537 across its forms' edges, k of 1, 11, 32,
              33 and V, every method, ties, -0.0, -inf, NaN, an empty
              partition: bitwise its plain version and its first
              design's on the card); where a K6 wrapper call's host
              time goes inside the kind program (``k6_host_split``:
              today's wrappers whole and part by part against the first
              design's wrappers part by part, in turns);
              the fixed-order fold at the
              uncollapsed window's set-up shape (``measure_fold``:
              bitwise its plain version on the CPU and on the card, over
              50 launches, timed beside the plain version and
              ``torch.sum``);
8. giant    — bench.py's giant-window tier (2048 operations, 4 spans a
              trace) from the port's ``testing.giant_window``, at the
              default 2 GiB budget: 2,097,152 spans (auto must resolve to
              packed_blocked) and 10,485,760 (pcsr), each through
              prepare_rank -> launch_rank -> finalize_rank with its
              partition given and its launches counted; top-5 tie-aware
              against the float64 sparse oracle (rtol 1e-3, as bench.py);
              stage times, rank-program device time and the main path's
              peak device memory; one step of the kernel within rtol 1e-6
              of its plain version on the card, bitwise over 50 launches,
              timed beside the library yardstick and the byte bound (for
              packed_blocked, K8's kernel bitwise the tile kernel in f32
              and timed in turns with it, the design's floor beside the
              bound, and a density sweep at the same shapes: synthetic
              bitmaps of 2%, 50% and 100% from a seeded generator, the
              two kernels bitwise each other and timed; for
              pcsr, ``measure_pcsr`` as in phase 6, against the pallas
              work list of the 10M-span window too); the window through
              the plain step, bitwise, K5 measured at its shapes (the
              kernels line's ``power_step`` at 10M), and the rank
              program's issue split; then the
              window stacked twice as one program (``giant_stacked``:
              the host's stacking time and bytes, the staging, 25
              launches of each kernel for the group, each window against
              its own program and through the plain step, the window-axis
              kernels bitwise the window's own launches over 50 launches,
              K5's group kernel over chains of 50 launches bitwise the
              plain step and PR 13's kernel, a step split by kernel (the
              group's step timed in turns with PR 13's kernel and, where
              a thread's values pass its slots, with them recomputed in
              place of held in shared memory: the kernels line's
              ``step_grid_group`` at 10M x 2),
              timed in turns with the two windows' own programs, peak
              device memory, the windows bitwise their own programs: a
              gate); the fold at the window's set-up shape.
              ``--giant-spans``
              sets the larger window (the smaller holds a fifth, the
              budget scales with it); 0 skips the phase;
   k13      — K13, the epilogue with a methods axis (every formula in one
              launch), at the config-5 kind window (V 3,072) and the
              10M-span giant window (V 2,048, measured in the giant
              phase), at k = n_rows and k = V (``measure_k13``): bitwise
              its plain version on the card and over 50 launches, row m
              bitwise the one-formula launch of formula m and the
              previous selection (the radix select past the warp-select),
              timed in turns with K13 and one launch on the previous
              selection, 13 one-formula launches and one, beside the plain
              version, the bound (the six input rows and the weights,
              scores and 13 rows of k out) and one stable ``torch.sort`` of
              the [13, V] negated scores (the top-k's library yardstick);
              a sweep of k from 33 to V timing the sort against the radix
              select, one formula and K13, that gives the share of V from
              which the sort wins (the plan's ``SORT_SHARE``,
              ``selection_sweep``);
              and the all-methods program in turns with 13 one-formula
              programs;
   stream   — the stream engine (``stream.run_stream``, ``cli stream``)
              over a config-5 timeline of 8 windows of 5 minutes (about
              --spans spans each, faults in windows 3, 4 and 5, the
              baseline seeded from the timeline's normal window;
              ``phase_stream``): the default (tumbling windows,
              pipeline_windows 3: the burst coalesces, each coalesced
              window's ranking bitwise its own one-window program),
              warm_start and fused_pair (sliding windows of slide 2.5
              minutes, pagerank tol 1e-4, 50 iterations: K19 launched on
              every warm window, rankings tie-aware the cold run's at
              rtol 1e-3; n_iters against the cold run's window by window
              and over the incident, and each warm init's nonzero
              entries, recorded: JAX's map misses kind columns across a
              slide, and its own engine can take more steps warm than
              cold), and the cold sliding run; the warm restart (an
              engine over the default run's warmup manifest dispatches
              every recorded occupancy and shape before its first
              window, counted with its run, none failed, then ranks
              bitwise as the default run did); then each ranked window
              ranked again warm from its own converged state (JAX's
              identical-window replay: within 3 steps, fewer than cold,
              the cold ranking); gates:
              only the faulted windows ranked, one incident with the
              fault at rank 1, opened and resolved; ms per window by stage,
              dispatches, the warm and cold programs' device ms by
              events, n_iters per window, spans per second;
   k19      — K19, the set-up's warm instance, at the config-5 kind window
              (the rows form) and the 10M-span giant window (the grid
              form, measured in the giant phase), each with an init mapped
              from the window itself (``measure_k19``): bitwise its plain
              version, an all-miss init bitwise the cold set-up, timed in
              turns with the cold set-up, beside the plain version and the
              byte bound (the cold set-up's bytes and the four init
              vectors);
   explain  — rank provenance (K15, ``ops/explain.py``,
              ``csrc/explain_epilogue.cu``; ``phase_explain``): K15 alone
              on every route's config-5 window (kind collapsed,
              packed_bf16, packed_blocked at 64 MiB, pcsr at 16 MiB,
              pallas, and the families phase's coo, csr, dense and
              dense_bf16) and on both giant windows (measured in the
              giant phase), each on its rank program's final rv and
              epilogue (``measure_k15``): bitwise its plain version on the
              card and over 50 launches, timed by events behind a spin in
              turns with the plain version and the selection's yardstick
              (one stable ``torch.sort`` of the [2, Ke, T] contribution
              rows), beside the byte bound; the explained program in
              turns with the one-formula program at the kind window; then
              the stream phase's timeline, tumbling, with
              ``ExplainConfig.enabled``, counted (one K15 call, one more
              rank program): one incident, one bundle under
              ``explain/`` and in the incident's flight dump (its
              manifest linking it), the journal's ``explain`` record
              naming the ranked window's top-1 and ef, ``GET
              /explainz?window=`` on a metrics server serving the
              bundle, ``python -m microrank_tpu_torch.cli explain OUT``
              naming the top-1, the fault among the first 5 suspects, and
              the bundle against the float64 oracle of the window
              (``explain.oracle``, uncollapsed, summed per kind): the
              top-5 tie-aware, counters, mass and top traces within rtol
              1e-3. The env phase builds K15 with the other libraries,
              gates 0 spill in its four kernels, and holds a small
              window's K15 bitwise its plain version on every route at J
              5 and 40.
   serve    — the online service (``serve/``, ``cli serve``) on the
              card, after the stream phase: the replay's six config-5
              windows staged as a dataset, the replay's normal dump as
              the baseline, an in-process ``ServeService`` and
              ``ServeHandle`` on 127.0.0.1 (warmup on, max_batch_windows
              8, max_wait_ms 200), six concurrent ``POST /rank`` of one
              window each, twice: every answer 200, the fault first,
              bitwise the replay's ``TableRCA`` ranking of the window,
              fewer dispatches than requests with a batch of two or
              more, the launch counts one window's a stacked group (K18),
              none degraded; per request its total ms and Server-Timing
              stages, the warmup's seconds, the first round against the
              second. ``explain: true`` on one window: one more program
              and one K15 call, the bundle's top-5 against the float64
              oracle (rtol 1e-3). Warm restart: a second service over
              the first one's warmup manifest dispatches every recorded
              shape at startup (the B = 6 one among them, none failed),
              then a round of the six windows, gated as the first, its
              latencies against the first service's first round.
              Inline: the eval harness's default case as JSON records,
              bitwise ``cli run`` on its CSV pair (one window). A failed
              dispatch: two injected failures answer 500 (no numpy_ref
              fallback on the card, none counted degraded), a
              ``degraded`` flight dump, the next request on the card;
              a queue of depth 1 answers 429 with a Retry-After.
              Co-deploy: serve and the stream phase's timeline (tumbling,
              the default mode) through one ``sched.DeviceScheduler``:
              the stream's windows, rankings and incidents its solo
              run's, serve's answers the first round's, no scheduler
              error, both lanes charged. Last ``python -m
              microrank_tpu_torch.cli serve`` as a process: one request,
              SIGTERM, exit 0 and a ``sigterm`` flight dump.
   chaos_warehouse — crash-only recovery and the trace warehouse on
              the stream phase's timeline, written as uncompressed
              warehouse directories (``--input`` / ``--normal``: no CSV
              parse), ``cli stream --source replay --warehouse``
              tumbling (pipeline 3, lateness 0): (a) uninterrupted in
              this process, then in a subprocess killed (``kill`` at the
              ``checkpoint`` seam, exit 137) at its fourth checkpoint,
              the faulted group's, and ``--resume``d here: one
              ``incident_open`` and one ``incident_resolve``, the
              incidents, every window's ranking and the manifest the
              uninterrupted run's, bitwise; every window sealed once
              (the journal's warm seals); seal_ms, checkpoint_ms, the
              checkpoint's load and the resume's seconds. (b) In this
              process, one window a dispatch, two failed dispatches
              and a poisoned fetch: no window dropped, the results
              bitwise the stream phase's default run, 3 retries, the
              launches those of the programs that ran (the poisoned
              attempt's included). (c) ``cli replay OUT --at all`` here,
              counted: ``match``, one stacked program a bucket, each
              stored blob's own program bitwise its stored ranking; the
              replay's ms a window against the live ``rank_ms``. (d)
              ``cli scenarios --from-warehouse`` here, counted (K13: one
              all-methods program a window), its 13 rows equal to
              ``run_retro`` on the CPU over a copy. (e) ``replay_range``
              on the backfill lane of a ``DeviceScheduler`` while a
              ``ServeService`` answers the three faulted windows: the
              answers the solo service's, the report ``match``, both
              tenants charged.

Then the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Without a CUDA device, or without the port beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Tolerances: K1 vs its plain version (the same arithmetic; an order
# difference is the only admissible deviation), and the CUDA run vs the
# CPU run (other reductions around K1 sum in another order).
KERNEL_RTOL = 1e-6
RUN_RTOL = 1e-5
RUN_RTOL_BF16 = 5e-3  # bf16 operands (packed_bf16, kind_precision="bf16")
RUN_RTOL_INT8 = 5e-2  # int8 operands: JAX's own int8 gate, over the top-5
STEPS = 25  # power-iteration steps per ranked window: one K1 launch each
STEP_LAUNCHES = 1  # the step kernel's launches per step (K5: one cooperative launch)
SPMVS_PER_STEP = 2 * 3  # partitions x SpMVs per step (pallas)
SS_SPMVS_PER_STEP = 2  # the call-graph terms of both partitions (kind, packed)
# K6 a program (or a stacked group): one set-up launch (csrc/rank_setup.cu)
# and one epilogue launch (csrc/rank_epilogue.cu); the standalone
# fixed-order fold (csrc/row_fold.cu) none, its tree inside both.
K6_LAUNCHES = 1
K6_REPS = 20  # timed calls of each K6 kernel at a run's window (full --reps in step, giant)
REPEATS = 50  # back-to-back launches that must give the first one's bits
SPIN_CYCLES = 4_000_000  # device-side spin before an event-timed call (~2 ms)
PROGRAM_SPIN_CYCLES = 200_000_000  # ~100 ms: longer than a rank program's issue
# bench.py's giant-window tier (BENCH_GIANT_SPANS, BENCH_GIANT_OPS
# defaults): at the default 2 GiB budget, the window of GIANT_SPANS / 5
# spans keeps its bitmaps (about 135 MB) but not its unpacked matrices
# (about 4.3 GB), so auto picks packed_blocked; the window of GIANT_SPANS
# spans has about 672 MB of bitmaps, past a quarter of the budget, so it
# picks pcsr.
GIANT_SPANS = 10_485_760
GIANT_OPS = 2048
DEFAULT_BUDGET = 2 << 30
ORACLE_RTOL = 1e-3  # bench.py's tie-aware top-5 parity against the float64 oracle
# What kernel="auto" resolves to at the config-5 window, per collapse mode.
AUTO_KERNEL = {"auto": "kind", "on": "kind", "off": "packed_bf16"}
# The window loop's modes in the replay phase: synchronous, the default
# (async dispatch, stream joins, depth 2) and async with bulk joins.
REPLAY_MODES = {
    "sync": dict(pipeline_depth=1, async_dispatch=False),
    "default": {},
    "bulk": dict(fetch_mode="bulk"),
    # bench.py's own replay configuration (_run_replay): bulk joins of
    # groups of four windows, each one stacked rank program.
    "chunked": dict(fetch_mode="bulk", dispatch_batch_windows=4),
    # run(batch_windows=True): every window detected, then all of them
    # built and ranked by one stacked program.
    "batch": {},
    # bench.py's chunked setting with kind_precision="int8": groups of
    # four int8 windows, each one stacked program (held to a per-window
    # int8 run).
    "chunked_int8": dict(fetch_mode="bulk", dispatch_batch_windows=4),
    # The default with `cli run --no-blob-staging`: each window's graph
    # copied leaf by leaf (the default stages one pinned blob a window).
    "tree": dict(blob_staging=False),
}
# The replay modes' kind_precision (f32 where not named).
REPLAY_PRECISION = {"chunked_int8": "int8"}
# The replay modes that rank stacked groups (K18).
STACKED_MODES = ("chunked", "batch", "chunked_int8")
# The stacked rank program's phase: groups of the replay's config-5 kind
# windows.
BATCH_SIZES = (1, 2, 4, 6)


# Seconds from the start of the run to each emitted line, by phase.
PHASE_SECONDS: dict = {}
_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        key = obj["phase"] if obj["phase"] not in PHASE_SECONDS else f"{obj['phase']}+"
        PHASE_SECONDS[key] = round(time.perf_counter() - _T0, 3)
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def reset_counts(spmv, pattern) -> None:
    """Every wrapper's launch count to 0, just before a main path runs."""
    from microrank_tpu_torch.ops import dense, epilogue, explain, fold, scan, setup, step

    dense.dense_matvecs.launches = dense.dense_matvecs.products = 0
    explain.explain_epilogue.launches = explain.explain_epilogue.kernel_launches = 0
    fold.fold_rows.launches = 0
    scan.csr_scan_spmv.launches = scan.csr_scan_spmv.products = 0
    setup.rank_setup.launches = setup.rank_setup.warm_launches = 0
    epilogue.rank_epilogue.launches = 0
    epilogue.rank_epilogue.by_kind.clear()

    spmv.coo_spmv.launches = spmv.coo_spmv.spmvs = 0
    spmv.pcsr_spmv_group.launches = spmv.pcsr_spmv_group.spmvs = 0
    pattern.pattern_pair_group.launches = pattern.pattern_pair_group.products = 0
    pattern.pattern_pair_group.blocked_launches = pattern.pattern_pair_group.fold_launches = 0
    pattern.quantize_scales.launches = 0
    step.power_step.launches = 0
    step.power_step.by_kernel.clear()


# The step kernels' instantiations that a counted main path launched
# (``power_step.by_kernel``'s names), for the kernels line.
MAIN_STEP_KERNELS = set()


def read_counts(spmv, pattern) -> dict:
    from microrank_tpu_torch.ops import dense, epilogue, explain, fold, scan, setup, step

    by_kernel = step.power_step.by_kernel
    MAIN_STEP_KERNELS.update(k for k, n in by_kernel.items() if n)
    return {
        "setup_launches": setup.rank_setup.launches,
        "epilogue_launches": epilogue.rank_epilogue.launches,
        "epilogue_all_methods_launches": epilogue.rank_epilogue.by_kind["all_methods"],
        "row_fold_launches": fold.fold_rows.launches,
        "step_launches": step.power_step.launches,
        "step_group_launches": sum(n for k, n in by_kernel.items()
                                   if k.startswith("step_grid_group")),
        "step_units_launches": by_kernel["step_grid_units"],
        "k1_launches": spmv.coo_spmv.launches,
        "k1_spmvs": spmv.coo_spmv.spmvs,
        "pcsr_launches": spmv.pcsr_spmv_group.launches,
        "pcsr_spmvs": spmv.pcsr_spmv_group.spmvs,
        "pattern_launches": pattern.pattern_pair_group.launches,
        "pattern_products": pattern.pattern_pair_group.products,
        "blocked_launches": pattern.pattern_pair_group.blocked_launches,
        "fold_launches": pattern.pattern_pair_group.fold_launches,
        "quantize_launches": pattern.quantize_scales.launches,
        "dense_launches": dense.dense_matvecs.launches,
        "dense_products": dense.dense_matvecs.products,
        "csr_scan_launches": scan.csr_scan_spmv.launches,
        "csr_scan_products": scan.csr_scan_spmv.products,
        "setup_warm_launches": setup.rank_setup.warm_launches,
        "explain_launches": explain.explain_epilogue.launches,
        "explain_kernel_launches": explain.explain_epilogue.kernel_launches,
    }


def expected_counts(kernel, n, int8=False, programs=None, folds=True, groups=0,
                    all_methods=False, warm=0, steps=STEPS, explained=None) -> dict:
    """The launch counts of ``n`` windows ranked with ``kernel``: one
    launch per step of K1 (pallas, coo: six SpMVs), one call of K10's
    scan per step (csr: six products, its launches on one stream), of the pcsr
    kernel (six SpMVs), of the dense kernel (dense, dense_bf16: six
    products), or of the pattern pair (four products; packed_blocked's
    through K8's own kernel, counted in blocked_launches too, and its
    fold launch) and K1 (the two call-graph terms); on every route one
    launch per step of the step kernel (K5); with ``int8`` (kind) one
    scale launch per window, for the first step (the step kernel takes
    every later step's scales); PR 13's group kernel never; on
    every route one launch of K6's set-up and one of its epilogue a
    program, and none of the standalone fixed-order fold (its tree runs
    inside both).
    ``programs``: the rank programs the windows ran in (stacked groups,
    K18: one launch of each kernel a step for the whole group; the
    SpMVs and products still count per window); default one a window.
    ``groups``: of them, the groups of two windows or more, whose steps
    launch K5's group kernel (``step_grid_group<S>``; a group of one
    launches the window's ``step_grid<S>``).
    ``folds``: packed_blocked's programs fold K8's partials (the
    condition the wrapper counts by, ``pattern.blocked_folds``; a small
    bitmap has no partials to fold).
    ``all_methods``: the programs rank every formula (K13), their one
    epilogue launch each with the methods axis. ``warm``: of the
    programs, those whose set-up took a warm init (K19). ``steps``: the
    programs' power-iteration steps (``PageRankConfig.iterations``).
    ``explained``: of the programs, the explained ones (K15), as (calls,
    the kernel launches ``ops.explain.explain_plan`` gives them), each
    one K15 call after its epilogue."""
    counts = dict.fromkeys(("setup_launches", "epilogue_launches",
                            "epilogue_all_methods_launches",
                            "row_fold_launches", "step_launches",
                            "step_group_launches", "step_units_launches", "k1_launches",
                            "k1_spmvs", "pcsr_launches",
                            "pcsr_spmvs", "pattern_launches", "pattern_products",
                            "blocked_launches", "fold_launches", "quantize_launches",
                            "dense_launches", "dense_products", "csr_scan_launches",
                            "csr_scan_products", "setup_warm_launches", "explain_launches",
                            "explain_kernel_launches"), 0)
    g = n if programs is None else programs
    counts["step_launches"] = STEP_LAUNCHES * steps * g
    counts["step_group_launches"] = STEP_LAUNCHES * steps * groups
    counts["setup_launches"] = counts["epilogue_launches"] = K6_LAUNCHES * g
    counts["epilogue_all_methods_launches"] = K6_LAUNCHES * g if all_methods else 0
    counts["setup_warm_launches"] = warm
    if explained is not None:
        counts["explain_launches"], counts["explain_kernel_launches"] = explained
    if kernel in ("pallas", "coo"):
        counts.update(k1_launches=steps * g, k1_spmvs=steps * SPMVS_PER_STEP * n)
    elif kernel == "csr":
        counts.update(csr_scan_launches=steps * g, csr_scan_products=steps * SPMVS_PER_STEP * n)
    elif kernel in ("dense", "dense_bf16"):
        counts.update(dense_launches=steps * g, dense_products=steps * SPMVS_PER_STEP * n)
    elif kernel == "pcsr":
        counts.update(pcsr_launches=steps * g, pcsr_spmvs=steps * SPMVS_PER_STEP * n)
    else:
        counts.update(k1_launches=steps * g, k1_spmvs=steps * SS_SPMVS_PER_STEP * n,
                      pattern_launches=steps * g, pattern_products=steps * 4 * n,
                      blocked_launches=steps * g if kernel == "packed_blocked" else 0,
                      fold_launches=steps * g if kernel == "packed_blocked" and folds else 0,
                      quantize_launches=g if int8 else 0)
    return counts


def host_folds(pattern, graph) -> bool:
    """Whether K8 folds partials over a host graph's bitmaps, as the
    wrapper decides it (``pattern.blocked_part_folds`` of each
    partition's V x T)."""
    return any(pattern.blocked_part_folds(int(g.cov_unique.shape[-1]), int(g.kind.shape[-1]))
               for g in (graph.normal, graph.abnormal))


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def tiny_pattern_checks(torch, pattern, dev):
    """First launches of the pattern pair and the int8 scale launch:
    small ragged bitmaps (a last partial byte, three row tiles and three
    column tiles, and a part of one tile) in every precision, and in f32
    through K8's kernel, against the plain version on the CPU, bitwise.
    Returns the number of cases."""
    import numpy as np

    g = torch.Generator().manual_seed(1)
    n = 0
    # Each precision through the tile kernel, then f32 through K8's.
    for precision, blocked in [(p_, False) for p_ in pattern.PRECISIONS] + [("f32", True)]:
        parts = []
        for v, k in ((300, 1100), (7, 9)):
            m = (torch.rand((v, k), generator=g) < 0.4).numpy().astype(np.uint8)
            vecs = [torch.rand(n_, generator=g) for n_ in (k, v, v, k, v)]
            parts.append((torch.from_numpy(np.packbits(m, axis=1)), k, vecs))
        int8 = precision == "int8"

        def group(on):
            return pattern.pattern_group(
                [p.to(on) for p, _, _ in parts],
                [w[0].to(on) for _, _, w in parts],
                [w[1].to(on) for _, _, w in parts],
                [None if int8 else w[2].to(on) for _, _, w in parts],
                [k for _, k, _ in parts], blocked=blocked,
            )

        rvs = [w[3] for _, _, w in parts]
        svs = [w[4] for _, _, w in parts]
        on_dev = group(dev)
        d_rvs, d_svs = [r.to(dev) for r in rvs], [s_.to(dev) for s_ in svs]
        scales = pattern.quantize_scales(on_dev, d_rvs, d_svs) if int8 else None
        outs = pattern.pattern_pair_group(on_dev, d_rvs, d_svs, precision, scales)
        torch.cuda.synchronize()
        cpu = group("cpu")
        ref_scales = pattern.quantize_scales_plain(cpu, rvs, svs) if int8 else None
        if int8:
            check(torch.equal(scales.cpu(), ref_scales),
                  "tiny quantize_amax launch differs from its plain version")
            check(not on_dev.amax_scratch.any(), "quantize_amax left its scratch non-zero")
        ref = pattern.pattern_pair_plain(cpu, rvs, svs, precision, ref_scales)
        for got, want in zip(outs, ref):
            for a, b in zip(got, want):
                check((a is None and b is None) or torch.equal(a.cpu(), b),
                      f"tiny pattern-pair launch ({precision}) differs from its plain version")
        n += 1
    return n


def tiny_pcsr_checks(torch, spmv, dev, layout, x):
    """First launches of the pcsr kernel: the tiny K1 work list (a row of
    three chunks, empty rows) with ELL slabs of widths 4 and 1024 (rows of
    700, 257 and 256 live entries, empty rows), then 1 and 64, then 4 and
    512 (one row of 300 entries beside rows of 0 to 40), each slab wider
    than 32 slots read in both of its modes (8 threads a row by the row's
    length, and a warp a row), against the plain version on the CPU,
    bitwise. Returns the number of launches."""
    g = torch.Generator().manual_seed(2)

    def ell(n_rows, width, counts, slot):
        n = torch.randint(0, width + 1, (n_rows,), generator=g)
        n[: len(counts)] = torch.tensor(counts)
        ops = torch.randint(0, 40, (n_rows, width), generator=g, dtype=torch.int32)
        vals = torch.rand((n_rows, width), generator=g) * 0.99 + 0.01
        pad = torch.arange(width) >= n[:, None]
        return spmv.ell_part(ops.masked_fill(pad, 0), vals.masked_fill(pad, 0.0), slot)

    xs = [x, torch.rand(40, generator=g), torch.rand(40, generator=g)]
    rows = spmv.spmv_group([layout], (0,), (x.shape[0],))
    n = 0
    for slabs in ((ell(300, 4, (0, 4, 1), 1), ell(9, 1024, (700, 257, 256, 0, 1024), 2)),
                  (ell(70, 1, (0, 1), 2), ell(33, 64, (0, 64, 63), 1)),
                  (ell(40, 4, (4, 0), 1), ell(64, 512, (300, *(i % 41 for i in range(63))), 2))):
        for wide in (spmv.ELL_SHORT, spmv.ELL_WARP):
            slabs = tuple(e if e.mode == spmv.ELL_SLAB else e._replace(mode=wide) for e in slabs)
            cpu = spmv.PcsrGroup(rows, slabs, (0, 1, 2))
            on_dev = spmv.PcsrGroup(
                spmv.SpmvGroup(*(t.to(dev) if torch.is_tensor(t) else t for t in rows)),
                tuple(spmv.EllPart(*(t.to(dev) if torch.is_tensor(t) else t for t in e))
                      for e in slabs),
                cpu.order,
            )
            got = spmv.pcsr_spmv_group(on_dev, [v.to(dev) for v in xs])
            torch.cuda.synchronize()
            for a, b in zip(got, spmv.pcsr_spmv_group_plain(cpu, xs)):
                check(torch.equal(a.cpu(), b),
                      f"tiny pcsr launch (wide mode {wide}) differs from its plain version")
            n += 1
    return n


def tiny_step_checks(torch, pattern, dev):
    """First launches of the step kernel (K5): two partitions of 7 x 9
    and 300 x 1,100 elements (one block, and several blocks a vector)
    over chains of three steps, with the default configuration, without
    normalization, with a tol that freezes after the first step, with
    an empty partition, with the int8 scales (a tiny pattern group's
    weights), and with the grid cut to one block a vector (partitions of
    300 x 1,500 and 300 x 11,000), so that each thread takes 6 elements
    (the carry in registers) and 43 (past the register slots). Each
    through one window of the fused kernel and through one-step calls
    of it (``power_step``), against the plain version on the card,
    bitwise. Then K5's group kernel (``tiny_group_step_checks``).
    Returns the number of cases."""
    import numpy as np

    from microrank_tpu_torch.ops import step

    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.Generator().manual_seed(3)
    small, mid, wide = [(7, 9), (300, 1100)], [(300, 1500)] * 2, [(300, 11_000)] * 2
    n = 0
    for tol, normalize, empty, scales, sizes, max_blocks in (
            (None, True, (), False, small, None),
            (None, False, (), False, small, None),
            ("half", True, (), False, small, None),
            (1e-4, True, (1,), False, small, None),
            (None, True, (), True, small, None),
            (1e-30, True, (), True, mid, 4),
            (1e-30, True, (), True, wide, 4)):
        group = pattern.pattern_group(
            [torch.from_numpy(np.packbits((torch.rand((v, t), generator=g) < 0.4).numpy()
                                          .astype(np.uint8), axis=1)).to(dev) for v, t in sizes],
            [torch.rand(t, generator=g).to(dev) for _, t in sizes],
            [torch.rand(v, generator=g).to(dev) for v, _ in sizes],
            [None, None], [t for _, t in sizes],
        )
        products, carry, prefs = random_step_inputs(torch, gen, sizes, dev, empty)
        if tol == "half":
            plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch(dev))
            res = torch.zeros((2, 1), device=dev)
            step.power_step_plain(plan, products, carry, res, 0)
            tol = float(res.max()) / 2
        plan = step.step_plan(prefs, 0.01, 0.85, tol, normalize, step.step_scratch(dev),
                              group if scales else None)
        want = step_chain(torch, step.power_step_plain, plan, products, carry, 3, scales)
        for label, fn in (("window", None), ("power_step", step.power_step)):
            got = step_chain(torch, fn, plan, products, carry, 3, scales, max_blocks)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"tiny step-kernel chain ({label}, tol={tol}, normalize={normalize}, "
                  f"empty={empty}, int8={scales}, max_blocks={max_blocks}) differs from its "
                  "plain version")
            check(not plan.scratch.any(), "the step kernel left its scratch non-zero")
        n += 1
    return n + tiny_group_step_checks(torch, pattern, dev)


def group_inputs(torch, gen, b, sizes, dev):
    """[B, n] products, carry and preference vectors per partition of
    (V, T) = sizes[p], uniform in [0, 1)."""
    def vec(n):
        return torch.rand((b, n), generator=gen, device=dev)

    products = tuple((vec(v), vec(v), vec(t)) for v, t in sizes)
    carry = tuple((vec(v), vec(t)) for v, t in sizes)
    return products, carry, [vec(t) for _, t in sizes]


def group_chain(torch, mode, plan, products, carry, n_steps, want_scales=False,
                max_blocks=None, hold=True, moving=None):
    """``n_steps`` steps of a group's StepWindow in ``mode`` (its grid
    capped at ``max_blocks``; ``hold``: values past the slots held in
    shared memory): each step's products the fixed ones, those of the
    windows in ``moving`` (a [B, 1] bool) times the carry, so that those
    windows move and the others repeat their first step. Returns (every
    step's carry and scales, the residuals, n_iters and running as the
    int32 bits of one tensor; the window)."""
    from microrank_tpu_torch.ops import step

    dev = carry[0][0].device
    b = carry[0][0].shape[0]
    residuals = torch.zeros((b, 2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if plan.tol is not None:
        n_iters = torch.zeros(b, dtype=torch.int32, device=dev)
        running = torch.ones(b, dtype=torch.bool, device=dev)
    win = step.StepWindow(plan, carry, residuals, n_iters, running, mode=mode,
                          max_blocks=max_blocks, hold=hold)
    out, c = [], carry
    for i in range(n_steps):
        ys = products
        if moving is not None:
            ys = tuple((torch.where(moving, y0 * sv, y0), y1, torch.where(moving, y2 * rv, y2))
                       for (y0, y1, y2), (sv, rv) in zip(products, c))
        c, scales = win.step(ys, i, want_scales and i + 1 < n_steps)
        out += [t.reshape(-1).clone() for part in c for t in part]
        out += [] if scales is None else [scales.reshape(-1).clone()]
    out = [torch.cat(out + [residuals.reshape(-1)]).view(torch.int32)]
    if n_iters is not None:
        out += [n_iters, running.to(torch.int32)]
    return torch.cat(out), win


def tiny_group_step_checks(torch, pattern, dev):
    """First launches of K5's group kernel (``step_grid_group<S>``):
    chains of three steps over groups of 2 to 4 windows, bitwise the
    plain step on the card and PR 13's kernel (``group_units``): small
    partitions (7 x 9 and 300 x 1,100) with the default configuration,
    with a tol whose odd windows move (products times the carry) while
    the even ones freeze, and with int8 scales; one block a (vector,
    window), so that a thread takes 43 elements (past the slots: held in
    shared memory, and recomputed) and 79 (past the held ones too); and
    a grid cap of 6 blocks for a group of 4 (one row of a window's 4
    units, which walks the other three windows). Returns the number of
    cases."""
    import numpy as np

    from microrank_tpu_torch.ops import step

    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.Generator().manual_seed(8)
    small, wide, far = [(7, 9), (300, 1100)], [(300, 11_000)] * 2, [(300, 20_000)] * 2
    n = 0
    for b, sizes, max_blocks, hold, tol, scales in (
            (3, small, None, True, None, False),
            (3, small, None, True, 1e-4, False),
            (3, small, None, True, None, True),
            (2, wide, 8, True, None, False),
            (2, wide, 8, False, 1e-30, True),
            (2, far, 8, True, None, True),
            (4, small, 6, True, 1e-4, False)):
        products, carry, prefs = group_inputs(torch, gen, b, sizes, dev)
        group = None
        if scales:
            group = pattern.pattern_group(
                [torch.from_numpy(np.packbits((torch.rand((b, v, t), generator=g) < 0.4).numpy()
                                              .astype(np.uint8), axis=-1)).to(dev)
                 for v, t in sizes],
                [torch.rand((b, t), generator=g).to(dev) for _, t in sizes],
                [torch.rand((b, v), generator=g).to(dev) for v, _ in sizes],
                [None, None], [t for _, t in sizes])
        moving = (torch.arange(b, device=dev) % 2 == 1)[:, None]
        chains = {}
        for mode in ("plain", "kernel", "group_units"):
            plan = step.step_plan(prefs, 0.01, 0.85, tol, True, step.step_scratch(dev, b), group)
            chains[mode], _ = group_chain(torch, mode, plan, products, carry, 3, scales,
                                          max_blocks, hold, moving)
            torch.cuda.synchronize()
            check(not plan.scratch.any(), f"the group step ({mode}) left its scratch non-zero")
        for mode in ("kernel", "group_units"):
            check(torch.equal(chains[mode], chains["plain"]),
                  f"tiny group step chain ({mode}, B={b}, sizes={sizes}, max_blocks="
                  f"{max_blocks}, hold={hold}, tol={tol}, int8={scales}) differs from the "
                  "plain step")
        n += 1
    return n


def tiny_fold_checks(torch, fold, dev):
    """First launches of the fixed-order fold: rows of one tile and of
    several (lengths 0, 1, short of the width, the width), against the
    plain version on the CPU, bitwise. Returns the number of cases."""
    gen = torch.Generator().manual_seed(5)
    n = 0
    for rows, width in ((3, 1), (4, 7), (5, 4096), (3, 4097), (6, 70_000)):
        x = torch.rand((rows, width), generator=gen)
        lengths = torch.randint(0, width + 1, (rows,), generator=gen, dtype=torch.int32)
        lengths[0] = 0
        lengths[-1] = width
        for given in (lengths, None):
            got = fold.fold_rows(x.to(dev), None if given is None else given.to(dev))
            torch.cuda.synchronize()
            check(torch.equal(got.cpu(), fold.fold_rows_plain(x, given)),
                  f"tiny fold launch ({rows} x {width}) differs from its plain version")
            n += 1
    return n


def measure_fold(torch, fold, name, graph, reps):
    """The fixed-order fold (``ops/fold.py``) at a window's set-up shape:
    the normal partition's two rows over its padded trace axis, each
    summed over its live count, on random values. Bitwise its plain
    version on the CPU and on the card and over 50 launches; timed by
    CUDA events behind a spin beside the plain version on the card and
    one ``torch.sum`` over the live columns (the library yardstick, in
    torch's own order); the bound reads the live values once and writes
    two floats, one add a value."""
    g = graph.normal
    t_pad = int(g.kind.shape[-1])
    n_live = int(g.n_cols) if int(g.n_cols) >= 0 else int(g.n_traces)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((2, t_pad), generator=gen)
    n = torch.full((2,), n_live, dtype=torch.int32)
    want = fold.fold_rows_plain(x, n)
    xd, nd = x.to("cuda"), n.to("cuda")
    first = fold.fold_rows(xd, nd)
    plain_card = fold.fold_rows_plain(xd, nd)
    torch.cuda.synchronize()
    check(torch.equal(first.cpu(), want), f"{name}: fold differs from its plain version")
    check(torch.equal(plain_card.cpu(), want), f"{name}: the plain fold differs on the card")
    for _ in range(REPEATS):
        check(torch.equal(fold.fold_rows(xd, nd), first), f"{name}: fold not repeatable")
    live = xd[:, :n_live]
    err = float((first.double().cpu() - x[:, :n_live].double().sum(-1)).abs().max())
    nbytes = 4 * 2 * n_live + 4 * 2 + 4 * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n_live / F32_FLOPS_PER_S * 1e3
    return {
        "rows": 2, "width": t_pad, "n_live": n_live,
        "bitwise_vs_plain": True, "repeat_bitwise": REPEATS,
        "max_abs_err": 0.0, "abs_err_vs_f64_sum": err,
        "ms": round(spin_event_ms(torch, lambda: fold.fold_rows(xd, nd), reps), 6),
        "plain_ms": round(spin_event_ms(torch, lambda: fold.fold_rows_plain(xd, nd), reps), 6),
        "library_ms": round(spin_event_ms(torch, lambda: live.sum(-1), reps), 6),
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


# The fields of a partition that K6's set-up reads, and that its
# epilogue reads (random partitions of the tiny checks and the sweep).
class SetupPart(NamedTuple):
    kind: object
    tracelen: object
    n_cols: object
    n_traces: object
    n_ops: object
    op_present: object


class EpiloguePart(NamedTuple):
    op_present: object
    cov_unique: object
    n_traces: object
    n_ops: object


def random_setup_part(torch, gen, t_pad, v, n_live, collapsed, lead, dev):
    """A partition of ``t_pad`` trace columns, ``n_live`` ([B] or one
    count) of them live, over ``v`` ops."""
    n_live = torch.as_tensor(n_live, dtype=torch.int32).expand(lead).contiguous()
    return SetupPart(
        kind=torch.randint(1, 51, lead + (t_pad,), generator=gen, dtype=torch.int32).to(dev),
        tracelen=torch.randint(1, 200, lead + (t_pad,), generator=gen,
                               dtype=torch.int32).to(dev),
        n_cols=(n_live if collapsed else torch.full(lead, -1, dtype=torch.int32)).to(dev),
        n_traces=(n_live * 3 + 1 if collapsed else n_live).to(dev),
        n_ops=torch.full(lead, max(1, v // 2), dtype=torch.int32).to(dev),
        op_present=(torch.rand(lead + (v,), generator=gen) < 0.6).to(dev),
    )


def setup_bits(torch, out):
    """Both partitions' (pref, sv0, rv0) as one int32 vector of bits."""
    return torch.cat([t.reshape(-1).view(torch.int32) for part in out for t in part])


def epilogue_bits(torch, out):
    """An epilogue's seven outputs as one int32 vector of bits."""
    return torch.cat([(t.view(torch.int32) if t.dtype == torch.float32 else t).reshape(-1)
                      for t in out])


def tiny_k6_checks(torch, dev):
    """First launches of K6: the set-up on partitions of 9 and 4,100
    trace columns (a block a row beside a cluster of two) and of 9 and
    40,000 (the grid form: 10 tiles a row), collapsed and not, both
    preference forms, one window and a stacked three (one with no live
    column); the epilogue on 300 ops (a block a window) and 9,000 (a
    cluster of two), one window and three, k of 11 (the warp-select) and
    40 (the radix select), every method. Each bitwise its plain version
    and the first design's kernel on the card. Returns the number of
    cases."""
    from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
    from microrank_tpu_torch.ops import epilogue, setup

    gen = torch.Generator().manual_seed(17)
    n = 0
    for wide in (4100, 40_000):
        for lead, live in (((), 7), ((3,), [9, 0, 4])):
            for collapsed in (False, True):
                for preference in ("reference", "paper"):
                    cfg = PageRankConfig(preference=preference)
                    parts = [random_setup_part(torch, gen, t, 300, live if t == 9 else
                                               [x * (wide // 9) for x in live] if lead
                                               else wide - 100, collapsed, lead, dev)
                             for t in (9, wide)]
                    got = setup.rank_setup(*parts, cfg)
                    want = setup.rank_setup_plain(*parts, cfg)
                    first = setup.rank_setup(*parts, cfg, first_design=True)
                    torch.cuda.synchronize()
                    check(torch.equal(setup_bits(torch, got), setup_bits(torch, want))
                          and torch.equal(setup_bits(torch, first), setup_bits(torch, want)),
                          f"tiny set-up launch ({wide} columns, lead {lead}, collapsed "
                          f"{collapsed}, {preference}) differs from its plain version")
                    n += 1
    for v in (300, 9000):
        for lead in ((), (3,)):
            parts, svs = random_epilogue_inputs(torch, gen, v, lead, dev)
            for k in (11, 40):
                for method in epilogue.METHOD_IDS:
                    cfg = SpectrumConfig(method=method, top_max=k, extra_rows=0)
                    got = epilogue.rank_epilogue(*parts, *svs, cfg)
                    want = epilogue.rank_epilogue_plain(*parts, *svs, cfg)
                    first = epilogue.rank_epilogue(*parts, *svs, cfg, first_design=True)
                    torch.cuda.synchronize()
                    check(torch.equal(epilogue_bits(torch, got), epilogue_bits(torch, want))
                          and torch.equal(epilogue_bits(torch, first),
                                          epilogue_bits(torch, want)),
                          f"tiny epilogue launch (V {v}, lead {lead}, k {k}, {method}) differs "
                          "from its plain version")
                    n += 1
    return n


def random_epilogue_inputs(torch, gen, v, lead, dev, flavor="random"):
    """Both partitions and final carries of an epilogue over ``v`` ops.
    ``flavor``: "random"; "ties" (carries from 8 values, coverages from
    4: many equal scores); "signed_zeros" (a third of the carries -0.0
    or +0.0); "nan" (a NaN in the abnormal carry of the first window);
    "empty_normal" (no normal op: NaN weights); "none_valid" (no op in
    either partition: every score -inf)."""
    parts, svs = [], []
    for n_traces in (80, 50):
        present = torch.rand(lead + (v,), generator=gen) < 0.7
        if flavor in ("empty_normal", "none_valid") and n_traces == 80 or (
                flavor == "none_valid"):
            present = torch.zeros_like(present)
        cov = torch.randint(1, 4 if flavor == "ties" else n_traces + 1, lead + (v,),
                            generator=gen, dtype=torch.int32) * present
        sv = torch.rand(lead + (v,), generator=gen)
        if flavor == "ties":
            sv = torch.floor(sv * 8) / 8
        if flavor == "signed_zeros":
            zero = torch.rand(lead + (v,), generator=gen) < 0.33
            sign = torch.where(torch.rand(lead + (v,), generator=gen) < 0.5, -0.0, 0.0)
            sv = torch.where(zero, sign, sv)
        sv = torch.where(present, sv, 0.0)
        if flavor == "nan" and n_traces == 50:
            sv.reshape(-1, v)[0, v // 3] = float("nan")
        parts.append(EpiloguePart(
            present.to(dev), cov.to(dev),
            torch.full(lead, n_traces if present.any() else 0, dtype=torch.int32).to(dev),
            present.sum(-1).to(torch.int32).to(dev)))
        svs.append(sv.to(dev))
    return parts, svs


EPILOGUE_FLAVORS = ("random", "ties", "signed_zeros", "nan", "empty_normal", "none_valid")


def epilogue_sweep(torch, dev):
    """The epilogue kernel against its plain version and the first
    design's kernel on the card over a seeded sweep: V of 8, 2,048,
    8,192 (a block's limit), 8,193 (a cluster of 2), 65,536 (a cluster
    of 8) and 65,537 (past a cluster: the first design), one window and
    a stacked three, k of 1, 11, 32, 33 (the warp-select's edge) and V,
    every method, and carries with ties, -0.0, -inf (invalid ops), NaN
    and an empty normal partition; bitwise, NaN compared by its bits.
    Returns the cases checked and the forms they ran."""
    from microrank_tpu_torch.config import SpectrumConfig
    from microrank_tpu_torch.ops import epilogue

    gen = torch.Generator().manual_seed(23)
    cases = 0
    forms = set()
    methods = list(epilogue.METHOD_IDS)
    card = epilogue.kernel_config(dev)
    sizes = (8, 2048, 8192, 8193, 65_536, 65_537)
    for v in sizes:
        for lead in ((), (3,)):
            for i, flavor in enumerate(EPILOGUE_FLAVORS):
                parts, svs = random_epilogue_inputs(torch, gen, v, lead, dev, flavor)
                for j, k in enumerate(sorted({1, min(11, v), min(32, v), min(33, v), v})):
                    plan = epilogue.epilogue_plan(v, k, lead[0] if lead else 1, card)
                    forms.add(f"{plan.form}/{plan.select}")
                    # Every method at every shape, a flavor and k turning.
                    for method in methods[(i + j) % 2::2] if v > 8 else methods:
                        cfg = SpectrumConfig(method=method, top_max=k, extra_rows=0)
                        got = epilogue_bits(torch, epilogue.rank_epilogue(*parts, *svs, cfg))
                        want = epilogue_bits(torch, epilogue.rank_epilogue_plain(*parts, *svs,
                                                                                 cfg))
                        first = epilogue_bits(torch, epilogue.rank_epilogue(
                            *parts, *svs, cfg, first_design=True))
                        check(torch.equal(got, want) and torch.equal(first, want),
                              f"epilogue sweep: V {v}, lead {lead}, {flavor}, k {k}, {method}: "
                              "the kernel or the first design differs from the plain version")
                        cases += 1
    torch.cuda.synchronize()
    return {"cases_bitwise_vs_plain_and_first_design": cases, "v": list(sizes),
            "k": "1, 11, 32, 33, V", "flavors": list(EPILOGUE_FLAVORS),
            "methods": len(methods), "windows": [1, 3], "forms": sorted(forms)}


def setup_bound(torch, graph):
    """K6's set-up bytes and operations on a staged graph: kind and
    tracelen read over the live columns, op_present read, pref and rv0
    written over the pads, sv0 over the ops; about 12 float operations a
    live column (two reciprocals, two products, the tree's two adds, the
    preference's four)."""
    nbytes = flops = 0
    for g in (graph.normal, graph.abnormal):
        n_live = torch.where(g.n_cols >= 0, g.n_cols, g.n_traces).clamp(0, g.kind.shape[-1])
        live = int(n_live.sum())
        cells = g.kind.numel()
        nbytes += 8 * live + 8 * cells + 5 * g.op_present.numel()
        flops += 12 * live
    return nbytes, flops


def epilogue_bound(graph, k):
    """K6's epilogue bytes and operations: each partition's sv,
    op_present and cov_unique read and weight and score written (17
    bytes an op), top_idx and top_scores written; about 40 float
    operations an op (two finishes, the counters, a formula)."""
    ops = graph.normal.op_present.numel()
    windows = ops // graph.normal.op_present.shape[-1]
    return 2 * 17 * ops + windows * (8 * k + 4), 40 * ops


# The epilogue's phases between its stamps (csrc kStamps): the slice
# into shared memory, the maxima, the scores and their tile nodes, the
# window's totals, the spectrum, the block's selection, the window's
# top-k written.
EPILOGUE_PHASES = ("load", "maxima", "scores", "totals", "spectrum", "select", "top_k")
# K10's scan_step between its stamps (global time, ns): the products
# and tile totals, the first grid barrier, the top scans, the
# down-sweeps and row offsets, the second barrier, the rows.
SCAN_PHASES = ("products_totals", "barrier_1", "top_scans", "down_sweeps_offsets", "barrier_2",
               "rows")
# The set-up's rows form between its stamps: the columns into
# registers, the tile's nodes, the row's sums, the writes.
SETUP_PHASES = ("load", "tree", "sums", "write")
# The grid form's (rows past 8 tiles): phase 1's tiles, sv0, the grid
# barrier, phase 2's tiles.
GRID_PHASES = ("phase1", "sv0", "barrier", "phase2")


def k6_turns(torch, fn, first_fn, reps):
    """A K6 kernel and its first design's, each by CUDA events behind a
    spin (the median of ``reps`` calls a turn), in turns (kernel, first,
    first, kernel): the four turns, the kernel's mean and the first
    design's."""
    turns = [spin_event_ms(torch, fn if side == "kernel" else first_fn, reps)
             for side in ("kernel", "first", "first", "kernel")]
    return {"turns_ms": [round(x, 6) for x in turns],
            "ms": round((turns[0] + turns[3]) / 2, 6),
            "first_design_ms": round((turns[1] + turns[2]) / 2, 6)}


def measure_k6(torch, name, dgraph, cfg, kernel, reps):
    """K6 at a staged window's (or group's) shapes: the set-up on its
    partitions and the epilogue on its program's final carries (the
    rank program run once, ``torch_cuda._rank_program``). Each kernel
    bitwise its plain version run on the card, bitwise the first
    design's kernel and bitwise over 50 launches; timed by CUDA events
    behind a spin in turns with the first design (``k6_turns``) beside
    the plain version, its bound (bytes once at 3.35 TB/s, or its
    operations at 67 TFLOP/s) and, for the epilogue's top-k, one stable
    ``torch.sort`` of the same negated scores (what the plain version
    sorts); each wrapper's host time alone (behind the spin), both
    designs; the launch each form planned."""
    from microrank_tpu_torch.ops import epilogue, setup
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    pr, sp = cfg.pagerank, cfg.spectrum
    g_n, g_a = dgraph.normal, dgraph.abnormal
    dev = g_n.kind.device
    first = setup_bits(torch, setup.rank_setup(g_n, g_a, pr))
    plain = setup_bits(torch, setup.rank_setup_plain(g_n, g_a, pr))
    check(torch.equal(first, plain), f"{name}: the set-up kernel differs from its plain version")
    check(torch.equal(setup_bits(torch, setup.rank_setup(g_n, g_a, pr, first_design=True)),
                      plain), f"{name}: the set-up's first design differs from its plain version")
    for _ in range(REPEATS):
        check(torch.equal(setup_bits(torch, setup.rank_setup(g_n, g_a, pr)), first),
              f"{name}: the set-up kernel is not repeatable")
    program = tc._rank_program(dgraph, pr, sp, kernel)
    svs = (program.sv_n, program.sv_a)
    e_first = epilogue_bits(torch, epilogue.rank_epilogue(g_n, g_a, *svs, sp))
    e_plain = epilogue_bits(torch, epilogue.rank_epilogue_plain(g_n, g_a, *svs, sp))
    check(torch.equal(e_first, e_plain),
          f"{name}: the epilogue kernel differs from its plain version")
    check(torch.equal(epilogue_bits(torch, epilogue.rank_epilogue(
        g_n, g_a, *svs, sp, first_design=True)), e_plain),
        f"{name}: the epilogue's first design differs from its plain version")
    for _ in range(REPEATS):
        check(torch.equal(epilogue_bits(torch, epilogue.rank_epilogue(g_n, g_a, *svs, sp)),
                          e_first), f"{name}: the epilogue kernel is not repeatable")
    check(torch.equal(epilogue_bits(torch, program.epilogue), e_first),
          f"{name}: the program's epilogue differs from the kernel's")
    plain_out = epilogue.rank_epilogue_plain(g_n, g_a, *svs, sp)
    scores, _ = epilogue.window_spectrum(plain_out.a_weight, g_a, plain_out.n_weight, g_n, sp)
    neg = -(scores + 0.0)
    k = int(program.epilogue.top_idx.shape[-1])
    v = int(g_n.op_present.shape[-1])
    windows = g_n.op_present.numel() // v
    t_pads = (int(g_n.kind.shape[-1]), int(g_a.kind.shape[-1]))

    def bound(nbytes, flops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        return {"bound_ms": round(max(bytes_ms, ops_ms), 6),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}

    def host_ms(fn):
        return round(spin_event_host_ms(torch, fn, reps)[1], 6)

    # Where the epilogue's time goes inside the kernel: the SM cycles
    # between the phases its first window stamps (the median of 9 calls).
    stamps = torch.zeros(epilogue.STAMPS, dtype=torch.int64, device=dev)
    cycles = []
    for _ in range(9):
        epilogue.rank_epilogue(g_n, g_a, *svs, sp, stamps=stamps)
        c = stamps.tolist()
        cycles.append([c[i + 1] - c[i] for i in range(epilogue.STAMPS - 1)])
    phase_cycles = dict(zip(EPILOGUE_PHASES, (int(_median([row[i] for row in cycles]))
                                              for i in range(epilogue.STAMPS - 1))))
    s_stamps = torch.zeros(setup.STAMPS, dtype=torch.int64, device=dev)
    cycles = []
    for _ in range(9):
        setup.rank_setup(g_n, g_a, pr, stamps=s_stamps)
        c = s_stamps.tolist()
        cycles.append([c[i + 1] - c[i] for i in range(setup.STAMPS - 1)])
    s_plan = setup.setup_plan(t_pads, windows, v, setup.kernel_config(dev))
    setup_cycles = dict(zip(GRID_PHASES if s_plan.form == "grid" else SETUP_PHASES,
                            (int(_median([row[i] for row in cycles]))
                             for i in range(setup.STAMPS - 1))))
    # The floor of a launch timed this way: one fill of one float.
    one = torch.empty(1, device=dev)
    floor_ms = round(spin_event_ms(torch, lambda: one.fill_(0.0), reps), 6)

    return {
        "setup": {
            "bitwise_vs_plain": True, "bitwise_vs_first_design": True,
            "repeat_bitwise": REPEATS, "max_abs_err": 0.0,
            **k6_turns(torch, lambda: setup.rank_setup(g_n, g_a, pr),
                       lambda: setup.rank_setup(g_n, g_a, pr, first_design=True), reps),
            # The wrapper call's host time (checks, outputs, launch),
            # issued while the device spins.
            "host_issue_ms": host_ms(lambda: setup.rank_setup(g_n, g_a, pr)),
            "first_design_host_issue_ms": host_ms(
                lambda: setup.rank_setup(g_n, g_a, pr, first_design=True)),
            "plain_ms": round(spin_event_ms(
                torch, lambda: setup.rank_setup_plain(g_n, g_a, pr), reps), 6),
            "library_ms": None,
            "plan": setup.setup_plan(t_pads, windows, v, setup.kernel_config(dev))._asdict(),
            "phase_cycles": setup_cycles,
            "launch_floor_ms": floor_ms,
            "first_design_plan": setup.setup_plan(t_pads, windows, v, setup.kernel_config(dev),
                                                  first_design=True)._asdict(),
            **bound(*setup_bound(torch, dgraph)),
        },
        "epilogue": {
            "bitwise_vs_plain": True, "bitwise_vs_first_design": True,
            "repeat_bitwise": REPEATS, "max_abs_err": 0.0, "k": k, "v": v,
            **k6_turns(torch, lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp),
                       lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp, first_design=True),
                       reps),
            "host_issue_ms": host_ms(lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp)),
            "first_design_host_issue_ms": host_ms(
                lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp, first_design=True)),
            "plain_ms": round(spin_event_ms(
                torch, lambda: epilogue.rank_epilogue_plain(g_n, g_a, *svs, sp), reps), 6),
            # The top-k alone as one library call: a stable sort of the
            # negated scores (the rest of the epilogue has none).
            "library_ms": round(spin_event_ms(
                torch, lambda: torch.sort(neg, dim=-1, stable=True), reps), 6),
            "plan": epilogue.epilogue_plan(v, k, windows, epilogue.kernel_config(dev))._asdict(),
            "phase_cycles": phase_cycles,
            **bound(*epilogue_bound(dgraph, k)),
        },
    }


def first_setup_wrapper(torch, marks):
    """A replica of the set-up wrapper's host side as the first design's
    wrapper had it (the fields checked one by one, the outputs split
    from one allocation, ``as_kernel_field`` and ``data_ptr`` a field,
    ctypes arrays of the pointers, ``torch.cuda.current_stream``, the
    call), each part's host time added into ``marks``; it launches the
    first design's kernel (through today's one packed call, whose
    packing is its own part, ``pack``: no part of the first wrapper)."""
    import ctypes

    from microrank_tpu_torch.ops import setup
    from microrank_tpu_torch.ops.setup import as_kernel_field

    def wrapper(normal, abnormal, cfg):
        t = time.perf_counter()

        def mark(label):
            nonlocal t
            now = time.perf_counter()
            marks[label] = marks.get(label, 0.0) + (now - t)
            t = now

        dev = normal.kind.device
        lead = tuple(normal.kind.shape[:-1])
        v = normal.op_present.shape[-1]
        for g in (normal, abnormal):
            if any(x.device != dev for x in (g.kind, g.tracelen, g.n_cols, g.n_traces, g.n_ops,
                                             g.op_present)):
                raise ValueError("every field must lie on the device")
            if (tuple(g.kind.shape[:-1]) != lead or g.tracelen.shape != g.kind.shape
                    or g.op_present.shape != lead + (v,)
                    or any(tuple(x.shape) != lead for x in (g.n_cols, g.n_traces, g.n_ops))):
                raise ValueError("shapes")
            if g.op_present.dtype != torch.bool or g.kind.shape[-1] > setup.MAX_WIDTH:
                raise ValueError("fields")
        windows = lead[0] if lead else 1
        parts = (normal, abnormal)
        t_pads = [int(g.kind.shape[-1]) for g in parts]
        tiles = [-(-x // setup.TILE) for x in t_pads]
        mark("check")
        sizes = [windows * n for x in t_pads for n in (x, x, v)] + [2 * windows * sum(tiles)]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        views = flat.split(sizes)
        if lead:
            views = [x.view(lead + (-1,)) for x in views[:-1]] + [views[-1]]
        outs = [(views[3 * p], views[3 * p + 2], views[3 * p + 1]) for p in range(2)]
        mark("outputs")
        ptrs = []
        for g, (pref, sv0, rv0) in zip(parts, outs):
            fields = [as_kernel_field(x) for x in (g.kind, g.tracelen, g.n_cols, g.n_traces,
                                                   g.n_ops)]
            fields.append(as_kernel_field(g.op_present, torch.bool))
            mark("as_kernel_field")
            ptrs += [x.data_ptr() for x in fields] + [pref.data_ptr(), rv0.data_ptr(),
                                                      sv0.data_ptr()]
            mark("data_ptr")
        kcfg = setup.kernel_config(dev)
        lib = setup.load_library()
        mark("config")
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int32 * 2)(*t_pads)
        mark("ctypes_arrays")
        stream = torch.cuda.current_stream(dev).cuda_stream
        mark("current_stream")
        plan = setup.setup_plan(t_pads, windows, v, kcfg, first_design=True)
        words = []
        for p in range(2):
            words += ptrs[9 * p: 9 * p + 9] + [t_pads[p]]
        args = setup.ARGS.pack(*words, windows, v, setup.f32_bits(cfg.phi),
                               int(cfg.preference == "paper"), setup.FORMS.index(plan.form),
                               plan.cluster, plan.grid, plan.hold,
                               views[-1].data_ptr() if sizes[-1] else 0, 0, dev.index, stream,
                               0, 0, 0, 0, 0)
        mark("pack")
        rc = lib.mr_rank_setup_launch(args)
        check(rc == 0, f"first set-up wrapper: launch failed ({rc})")
        setup.rank_setup.launches += 1
        mark("call")
        return outs[0], outs[1]

    return wrapper


def first_epilogue_wrapper(torch, marks):
    """``first_setup_wrapper`` for the epilogue."""
    import ctypes

    from microrank_tpu_torch.ops import epilogue
    from microrank_tpu_torch.ops.setup import as_kernel_field

    def wrapper(normal, abnormal, sv_n, sv_a, spectrum_cfg):
        t = time.perf_counter()

        def mark(label):
            nonlocal t
            now = time.perf_counter()
            marks[label] = marks.get(label, 0.0) + (now - t)
            t = now

        method = epilogue.method_id(spectrum_cfg.method)
        lead = tuple(sv_n.shape[:-1])
        v = sv_n.shape[-1]
        dev = sv_n.device
        for g, sv in ((normal, sv_n), (abnormal, sv_a)):
            if sv.shape != sv_n.shape or sv.dtype != torch.float32 or sv.device != dev:
                raise ValueError("sv")
            if (g.op_present.shape != sv.shape or g.cov_unique.shape != sv.shape
                    or tuple(g.n_traces.shape) != lead or tuple(g.n_ops.shape) != lead):
                raise ValueError("shapes")
            if g.op_present.dtype != torch.bool:
                raise ValueError("bool")
            if any(x.device != dev for x in (g.op_present, g.cov_unique, g.n_traces, g.n_ops)):
                raise ValueError("device")
        windows = lead[0] if lead else 1
        k = min(spectrum_cfg.n_rows, v)
        k_pad = 1 << (k - 1).bit_length()
        tiles = -(-v // epilogue.TILE)
        mark("check")
        n = windows * v
        sizes = [n, n, n, n, n, windows * 2 * tiles if tiles > 1 else 0,
                 windows * k, windows * k, windows]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        (w_n, s_n, w_a, s_a, scores, nodes, top_idx, top_scores, n_valid) = flat.split(sizes)
        keys = None
        if k_pad > epilogue.SMEM_KEYS:
            keys = torch.empty(windows * k_pad, dtype=torch.int64, device=dev)
        mark("outputs")
        fields = []
        for g, sv, w, s in ((normal, sv_n, w_n, s_n), (abnormal, sv_a, w_a, s_a)):
            fields += [as_kernel_field(sv, torch.float32),
                       as_kernel_field(g.op_present, torch.bool),
                       *(as_kernel_field(x) for x in (g.cov_unique, g.n_traces, g.n_ops)), w, s]
        mark("as_kernel_field")
        ptrs = [x.data_ptr() for x in fields] + [
            scores.data_ptr(), nodes.data_ptr() if tiles > 1 else None,
            None if keys is None else keys.data_ptr(),
            top_idx.data_ptr(), top_scores.data_ptr(), n_valid.data_ptr(),
        ]
        mark("data_ptr")
        lib = epilogue.load_library()
        mark("config")
        (ctypes.c_void_p * len(ptrs))(*ptrs)
        mark("ctypes_arrays")
        stream = torch.cuda.current_stream(dev).cuda_stream
        mark("current_stream")
        args = epilogue.ARGS.pack(
            *[x or 0 for x in ptrs[:14]], ptrs[14], ptrs[15] or 0, ptrs[16] or 0, ptrs[17],
            ptrs[18], ptrs[19], 0, 0, 0, 0, 0, windows, v, k, k_pad, method, 1,
            epilogue.f32_bits(spectrum_cfg.eps),
            epilogue.FORMS.index("first"), 1, v, 0, 0, dev.index, stream)
        mark("pack")
        rc = lib.mr_rank_epilogue_launch(args)
        check(rc == 0, f"first epilogue wrapper: launch failed ({rc})")
        epilogue.rank_epilogue.launches += 1
        mark("call")
        top_idx, n_valid = top_idx.view(torch.int32), n_valid.view(torch.int32)
        if not lead:
            out = epilogue.Epilogue(w_n, w_a, s_n, s_a, top_idx, top_scores, n_valid.view(()))
        else:
            vec, top = lead + (v,), lead + (k,)
            out = epilogue.Epilogue(w_n.view(vec), w_a.view(vec), s_n.view(vec), s_a.view(vec),
                                    top_idx.view(top), top_scores.view(top), n_valid)
        mark("outputs_views")
        return out

    return wrapper


def today_setup_wrapper(torch, marks):
    """``ops.setup.rank_setup`` on the card replicated part by part (the
    check, the plan, the outputs, the pointers, the packed block, the
    call), each part's host time added into ``marks``."""
    from microrank_tpu_torch.ops import setup
    from microrank_tpu_torch.ops.setup import as_kernel_field

    def wrapper(normal, abnormal, cfg):
        t = time.perf_counter()

        def mark(label):
            nonlocal t
            now = time.perf_counter()
            marks[label] = marks.get(label, 0.0) + (now - t)
            t = now

        dev = normal.kind.device
        windows, v = setup._check(normal, abnormal)
        t_n, t_a = normal.kind.shape[-1], abnormal.kind.shape[-1]
        index = dev.index
        mark("check")
        plan = setup._plan(t_n, t_a, windows, v, index, False)
        mark("plan")
        sizes = (windows * t_n, windows * t_n, windows * v, windows * t_a, windows * t_a,
                 windows * v, 0 if plan.form == "rows" else 2 * plan.tree_items)
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        views = torch.split_with_sizes(flat, sizes)
        if normal.kind.dim() > 1:
            views = [x.view(windows, n) for x, n in zip(views, (t_n, t_n, v, t_a, t_a, v))]
        mark("outputs")
        at = flat.data_ptr()
        ptrs = []
        for n in sizes:
            ptrs.append(at)
            at += 4 * n
        words, fields = [], []
        for g, out, t_pad in ((normal, ptrs[0:3], t_n), (abnormal, ptrs[3:6], t_a)):
            part = [as_kernel_field(g.kind), as_kernel_field(g.tracelen),
                    as_kernel_field(g.n_cols), as_kernel_field(g.n_traces),
                    as_kernel_field(g.n_ops), as_kernel_field(g.op_present, torch.bool)]
            fields += part
            words += [f.data_ptr() for f in part] + [out[0], out[1], out[2], t_pad]
        mark("pointers")
        lib = setup.load_library()
        args = setup.ARGS.pack(
            *words, windows, v, setup.f32_bits(cfg.phi), int(cfg.preference == "paper"),
            setup.FORMS.index(plan.form), plan.cluster, plan.grid, plan.hold,
            ptrs[6] if sizes[6] else 0, 0, index,
            torch._C._cuda_getCurrentRawStream(index), 0, 0, 0, 0, 0)
        mark("pack")
        rc = lib.mr_rank_setup_launch(args)
        check(rc == 0, f"set-up wrapper replica: launch failed ({rc})")
        setup.rank_setup.launches += 1
        mark("call")
        return (views[0], views[2], views[1]), (views[3], views[5], views[4])

    return wrapper


def today_epilogue_wrapper(torch, marks):
    """``today_setup_wrapper`` for ``ops.epilogue.rank_epilogue``."""
    from microrank_tpu_torch.ops import epilogue
    from microrank_tpu_torch.ops.setup import as_kernel_field

    def wrapper(normal, abnormal, sv_n, sv_a, spectrum_cfg):
        t = time.perf_counter()

        def mark(label):
            nonlocal t
            now = time.perf_counter()
            marks[label] = marks.get(label, 0.0) + (now - t)
            t = now

        dev = sv_n.device
        method = epilogue.method_id(spectrum_cfg.method)
        lead, v = epilogue._check(normal, abnormal, sv_n, sv_a)
        windows = lead[0] if lead else 1
        k = min(spectrum_cfg.n_rows, v)
        index = dev.index
        mark("check")
        plan = epilogue._plan(v, k, windows, index, False)
        mark("plan")
        n = windows * v
        sizes = (n, n, n, n, windows * k, windows * k, windows)
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        w_n, s_n, w_a, s_a, top_idx, top_scores, n_valid = torch.split_with_sizes(flat, sizes)
        mark("outputs")
        at = flat.data_ptr()
        ptrs = []
        for size in sizes:
            ptrs.append(at if size else 0)
            at += 4 * size
        words, fields = [], []
        for g, sv, out in ((normal, sv_n, ptrs[0:2]), (abnormal, sv_a, ptrs[2:4])):
            part = [as_kernel_field(sv, torch.float32), as_kernel_field(g.op_present, torch.bool),
                    as_kernel_field(g.cov_unique), as_kernel_field(g.n_traces),
                    as_kernel_field(g.n_ops)]
            fields += part
            words += [f.data_ptr() for f in part] + [out[0], out[1]]
        mark("pointers")
        lib = epilogue.load_library()
        args = epilogue.ARGS.pack(
            *words, 0, 0, 0, ptrs[4], ptrs[5], ptrs[6], 0, 0, 0, 0, 0, windows, v, k,
            plan.k_pad, method, 1,
            epilogue.f32_bits(spectrum_cfg.eps), epilogue.FORMS.index(plan.form), plan.cluster,
            plan.slice, plan.smem, plan.sort_keys, index,
            torch._C._cuda_getCurrentRawStream(index))
        mark("pack")
        rc = lib.mr_rank_epilogue_launch(args)
        check(rc == 0, f"epilogue wrapper replica: launch failed ({rc})")
        epilogue.rank_epilogue.launches += 1
        mark("call")
        top_idx, n_valid = top_idx.view(torch.int32), n_valid.view(torch.int32)
        if not lead:
            out = epilogue.Epilogue(w_n, w_a, s_n, s_a, top_idx, top_scores, n_valid.view(()))
        else:
            out = epilogue.Epilogue(w_n.view(windows, v), w_a.view(windows, v),
                                    s_n.view(windows, v), s_a.view(windows, v),
                                    top_idx.view(windows, k), top_scores.view(windows, k),
                                    n_valid)
        mark("outputs_views")
        return out

    return wrapper


def k6_host_split(torch, dgraph, cfg, kernel, reps=5, warm_ms=2.0):
    """Where a K6 wrapper call's host time goes inside the rank program
    (``rank_window_traced_core`` behind a ~100 ms spin, so no wait on
    the device is in it), with wrappers put in place of the names
    ``torch_cuda`` calls: today's wrappers timed whole (``today``);
    today's replicated part by part (``today_parts``:
    ``today_setup_wrapper``, ``today_epilogue_wrapper``); the first
    design's wrappers replicated part by part (``first_parts``); and
    today's timed whole after the host has run for ``warm_ms`` ms right
    before the program (``today_warm``: the program then does not start
    on a host just woken from the previous program's synchronize); and
    today's timed whole with Python's garbage collector off for the
    program (``today_nogc``). In turns (today, today_parts, first_parts,
    today_warm, today_nogc, today_nogc, today_warm, first_parts,
    today_parts, today); medians over ``reps`` programs of each side's
    turns, in ms. Each program's ranking is bitwise the first
    program's."""
    import gc

    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    saved = {name: getattr(tc, name) for name in ("rank_setup", "rank_epilogue")}

    def timed(label, fn, marks):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            marks[label] = marks.get(label, 0.0) + time.perf_counter() - t0
            return out
        return call

    makers = {
        "today": lambda m: (saved["rank_setup"], saved["rank_epilogue"]),
        "today_warm": lambda m: (saved["rank_setup"], saved["rank_epilogue"]),
        "today_nogc": lambda m: (saved["rank_setup"], saved["rank_epilogue"]),
        "today_parts": lambda m: (today_setup_wrapper(torch, m[0]),
                                  today_epilogue_wrapper(torch, m[1])),
        "first_parts": lambda m: (first_setup_wrapper(torch, m[0]),
                                  first_epilogue_wrapper(torch, m[1])),
    }
    order = ("today", "today_parts", "first_parts", "today_warm", "today_nogc", "today_nogc",
             "today_warm", "first_parts", "today_parts", "today")
    want = None
    rows = {side: [] for side in makers}
    try:
        for side in order:
            for rep in range(reps + 1):
                marks = ({}, {})
                fns = makers[side](marks)
                tc.rank_setup = timed("total", fns[0], marks[0])
                tc.rank_epilogue = timed("total", fns[1], marks[1])
                torch.cuda._sleep(PROGRAM_SPIN_CYCLES)
                if side == "today_warm":
                    until = time.perf_counter() + warm_ms / 1e3
                    while time.perf_counter() < until:
                        pass
                if side == "today_nogc":
                    gc.disable()
                try:
                    outs = tc.rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum,
                                                      kernel)
                finally:
                    gc.enable()
                torch.cuda.synchronize()
                got = [x.cpu() for x in outs[:3]]
                if want is None:
                    want = got
                check(all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                      y.view(torch.int32) if y.dtype == torch.float32 else y)
                          for x, y in zip(got, want)),
                      f"k6 host split ({side}): the ranking differs from the first program's")
                if rep:  # the first program of a turn warms it
                    rows[side].append({"setup": marks[0], "epilogue": marks[1]})
    finally:
        for name, fn in saved.items():
            setattr(tc, name, fn)
    out = {"reps": reps, "order": ", ".join(order), "warm_ms": warm_ms}
    for side, runs in rows.items():
        out[side] = {
            part: {label: round(_median([r[part].get(label, 0.0) for r in runs]) * 1e3, 4)
                   for label in runs[0][part]}
            for part in ("setup", "epilogue")}
    return out


def ptxas_all(report, kernel):
    """ptxas's lines for every kernel of a ``-Xptxas -v`` report whose
    name holds ``kernel``: its entry, properties (stack, spills) and
    registers."""
    lines = [ln.strip() for ln in report.splitlines()]
    return [lines[k: k + 4] for k, ln in enumerate(lines)
            if "Compiling entry function" in ln and kernel in ln]


def ptxas_spills(report, names):
    """Registers and spill bytes of every kernel of a ``-Xptxas -v``
    report whose name holds one of ``names``, keyed by that name (with
    its bool template arguments, where it has them)."""
    out = {}
    for lines in ptxas_all(report, ""):
        name = next((n for n in names if n in lines[0]), None)
        if name is None:
            continue
        text = " ".join(lines)
        args = re.search(name + r"I((?:Lb\d+E)+)E", lines[0])
        flags = [] if args is None else re.findall(r"Lb(\d+)E", args.group(1))
        key = name + ("" if not flags else
                      "<" + ", ".join("true" if f == "1" else "false" for f in flags) + ">")
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        check(regs and spill, f"ptxas: no report for {lines[0]}")
        out[key] = {"registers": int(regs.group(1)), "spill_store_bytes": int(spill.group(1)),
                    "spill_load_bytes": int(spill.group(2))}
    return out


def tiny_dense_checks(torch, dev):
    """First launches of the dense kernel (K12): small groups of six
    matrices with ragged column counts, row strides past one step, f32
    and bf16, one window and three, bitwise their plain version on the
    CPU, and a vector that does not start on a 16-byte boundary."""
    from microrank_tpu_torch.ops import dense
    from microrank_tpu_torch.rank_backends.torch_cuda import STEP_X_SLOTS

    gen = torch.Generator().manual_seed(12)
    n = 0
    for bf16 in (False, True):
        for windows in (None, 3):
            lead = () if windows is None else (windows,)
            mult = dense.row_multiple(bf16)
            mats, n_cols = [], []
            for t in (300, 9):
                for rows, cols in ((37, t), (37, 37), (t, 37)):
                    ld = -(-cols // mult) * mult + mult
                    m = torch.zeros(lead + (rows, ld))
                    m[..., :cols] = torch.rand(lead + (rows, cols), generator=gen)
                    m[..., :cols] *= torch.rand(lead + (rows, cols), generator=gen) < 0.4
                    mats.append(m.to(torch.bfloat16) if bf16 else m)
                    n_cols.append(cols)
            xs = [torch.rand(lead + (k,), generator=gen) for k in (300, 37, 9, 37)]
            group = dense.DenseGroup(tuple(mats), STEP_X_SLOTS, tuple(n_cols), bf16, windows)
            want = dense.dense_matvecs_plain(group, xs)
            card = group._replace(mats=tuple(m.to(dev) for m in mats))
            dense.check_group(card, dev)
            dxs = [x.to(dev) for x in xs]
            if windows is None:  # one vector one float off a 16-byte boundary
                buf = torch.zeros(301, device=dev)
                buf[1:] = dxs[0]
                dxs[0] = buf[1:]
            got = dense.dense_matvecs(card, dxs)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(torch.equal(bits(torch, g.cpu()), bits(torch, w)),
                      f"tiny dense launch (bf16={bf16}, windows={windows}) differs from its "
                      "plain version")
            n += 1
    return n


def tiny_check_word_checks(torch, dev):
    """K14's check word in the epilogue's forms (a block, a cluster of
    two, the first design), one window and three, with and without a
    residual trace, on carries with a NaN and without: the word bitwise
    its plain version, every other output bitwise the unchecked
    launch's."""
    from microrank_tpu_torch.config import SpectrumConfig
    from microrank_tpu_torch.ops import epilogue
    from microrank_tpu_torch.ops.epilogue import check_word_plain

    gen = torch.Generator().manual_seed(14)
    cfg = SpectrumConfig()
    n = 0
    for v, first in ((300, False), (9000, False), (300, True)):
        for windows in (None, 3):
            for poison in (False, True):
                lead = () if windows is None else (windows,)
                parts = []
                for traces in (4000, 2500):
                    present = torch.rand(lead + (v,), generator=gen) < 0.7
                    cov = torch.where(present, torch.randint(1, traces, lead + (v,),
                                                             generator=gen), 0).to(torch.int32)
                    parts.append(EpiloguePart(present, cov,
                                              torch.full(lead, traces, dtype=torch.int32),
                                              present.sum(-1).to(torch.int32)))
                svs = [torch.where(p.op_present, torch.rand(lead + (v,), generator=gen), 0.0)
                       for p in parts]
                res = torch.rand(lead + (2, STEPS), generator=gen)
                iters = torch.full(lead, STEPS - 3, dtype=torch.int32)
                res[..., STEPS - 1] = float("nan")  # past n_iters: never flagged
                if poison:
                    svs[1].reshape(-1, v)[:, 2] = float("nan")
                    res.reshape(-1, 2, STEPS)[0, 0, 4] = float("inf")
                want = epilogue.rank_epilogue_plain(*parts, *svs, cfg)
                want_word = check_word_plain(want.top_scores, want.n_valid, res, iters)
                dp = [EpiloguePart(*(t.to(dev) for t in p)) for p in parts]
                dsv = [t.to(dev) for t in svs]
                got, word = epilogue.rank_epilogue_checked(*dp, *dsv, cfg, res.to(dev),
                                                           iters.to(dev), first_design=first)
                plain = epilogue.rank_epilogue(*dp, *dsv, cfg, first_design=first)
                torch.cuda.synchronize()
                check(torch.equal(word.cpu(), want_word),
                      f"tiny check word (v={v}, first={first}, windows={windows}, "
                      f"poison={poison}) {word.cpu().tolist()}, plain {want_word.tolist()}")
                check(torch.equal(epilogue_bits(torch, got), epilogue_bits(torch, plain)),
                      "a checked epilogue's outputs are not bitwise the unchecked launch's")
                n += 1
    return n


def function_spills(report, name):
    """Stack and spill bytes of a device function (not an entry) of a
    ``-Xptxas -v`` report whose name holds ``name``."""
    lines = [ln.strip() for ln in report.splitlines()]
    out = []
    for k, ln in enumerate(lines):
        if "Function properties for" in ln and name in ln and k + 1 < len(lines):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", lines[k + 1])
            check(m, f"ptxas: no properties for {ln}")
            out.append([int(g) for g in m.groups()])
    return out


def phase_env(torch, spmv, pattern, native):
    from microrank_tpu_torch.ops import dense, epilogue, explain, fold, scan, setup, step

    # Build the ten libraries from the checkout's sources, in parallel.
    for lib in (spmv.LIB_PATH, pattern.LIB_PATH, step.LIB_PATH, fold.LIB_PATH,
                setup.LIB_PATH, epilogue.LIB_PATH, dense.LIB_PATH, scan.LIB_PATH,
                explain.LIB_PATH, native.LIB_PATH):
        lib.unlink(missing_ok=True)

    def timed(fn):
        t0 = time.perf_counter()
        report = fn()
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(10) as pool:
        f_cuda = pool.submit(timed, spmv.build_library)
        f_pattern = pool.submit(timed, pattern.build_library)
        f_step = pool.submit(timed, step.build_library)
        f_fold = pool.submit(timed, fold.build_library)
        f_setup = pool.submit(timed, setup.build_library)
        f_epilogue = pool.submit(timed, epilogue.build_library)
        f_dense = pool.submit(timed, dense.build_library)
        f_scan = pool.submit(timed, scan.build_library)
        f_explain = pool.submit(timed, explain.build_library)
        f_host = pool.submit(timed, native.build_library)
        cuda_s, ptxas = f_cuda.result()
        pattern_s, ptxas_pattern = f_pattern.result()
        step_s, ptxas_step = f_step.result()
        fold_s, ptxas_fold = f_fold.result()
        setup_s, ptxas_setup = f_setup.result()
        epilogue_s, ptxas_epilogue = f_epilogue.result()
        dense_s, ptxas_dense = f_dense.result()
        scan_s, ptxas_scan = f_scan.result()
        explain_s, ptxas_explain = f_explain.result()
        host_s, _ = f_host.result()
    for module in (spmv, pattern, step, fold, setup, epilogue, dense, scan, explain):
        module.load_library()

    # First launch: a tiny ragged matrix (empty rows, a 700-entry row of
    # three chunks, padding) against the plain version, before anything
    # big runs.
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = torch.cat([torch.zeros(700, dtype=torch.int32),
                      torch.randint(0, 37, (300,), generator=g, dtype=torch.int32),
                      torch.zeros(30, dtype=torch.int32)])
    cols = torch.randint(0, 53, (1030,), generator=g, dtype=torch.int32)
    cols[-30:] = 0
    vals = torch.rand(1030, generator=g)
    vals[-30:] = 0.0
    x = torch.rand(53, generator=g)
    lay = spmv.row_layout(rows.to(dev), cols.to(dev), vals.to(dev), 37, 1000)
    y = spmv.coo_spmv(lay, x.to(dev))
    torch.cuda.synchronize()
    host_lay = spmv.row_layout(rows, cols, vals, 37, 1000)
    tiny_bitwise = bool(torch.equal(y.cpu(), spmv.coo_spmv_plain(host_lay, x)))
    check(tiny_bitwise, "tiny K1 launch differs from its plain version")
    n_pcsr = tiny_pcsr_checks(torch, spmv, dev, host_lay, x)
    n_pattern = tiny_pattern_checks(torch, pattern, dev)
    n_step = tiny_step_checks(torch, pattern, dev)
    # Every instantiation of K5's group kernel without spill (the gate):
    # registers, spill stores and loads by instantiation.
    group_ptxas = {}
    for lines in ptxas_all(ptxas_step, "step_grid_group"):
        text = " ".join(lines)
        name = re.search(r"step_grid_groupILi(\d+)E", lines[0])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        check(name and regs and spill, f"ptxas: no report for {lines[0]}")
        group_ptxas[f"step_grid_group<{name.group(1)}>"] = {
            "registers": int(regs.group(1)), "spill_store_bytes": int(spill.group(1)),
            "spill_load_bytes": int(spill.group(2))}
    want_slots = {1, 2, 4, 8, step.kernel_config(dev).group_slots}
    check(len(group_ptxas) == len(want_slots),
          f"ptxas: {sorted(group_ptxas)}, want step_grid_group<S> for S in {sorted(want_slots)}")
    spilled = {k: v for k, v in group_ptxas.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]}
    check(not spilled, f"ptxas: step_grid_group spills: {spilled}")
    # Every kernel of K6's two libraries without spill (the gate): the
    # set-up's rows form (a block, a cluster), grid form and first
    # design; the epilogue's window form (a block, a cluster) and first
    # design.
    k6_ptxas = {**ptxas_spills(ptxas_setup, ("setup_rows", "setup_grid", "setup_first")),
                **ptxas_spills(ptxas_epilogue, ("epilogue_window", "epilogue_first"))}
    # setup_rows<clustered, warm>, setup_grid<warm>: K19's warm
    # instances beside the cold ones.
    want_k6 = {"setup_rows<false, false>", "setup_rows<true, false>", "setup_rows<false, true>",
               "setup_rows<true, true>", "setup_grid<false>", "setup_grid<true>", "setup_first",
               "epilogue_window<false, false>", "epilogue_window<true, false>",
               "epilogue_window<false, true>", "epilogue_window<true, true>",
               "epilogue_first"}
    check(set(k6_ptxas) == want_k6, f"ptxas: K6 reports {sorted(k6_ptxas)}, want "
                                    f"{sorted(want_k6)}")
    spilled = {k: v for k, v in k6_ptxas.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]}
    check(not spilled, f"ptxas: K6 kernels spill: {spilled}")
    # K14's check word (the epilogue's device function check_window) and
    # K12's kernel in f32 and bf16 without spill (gates).
    check_word_ptxas = function_spills(ptxas_epilogue, "check_window")
    check(check_word_ptxas and not any(s or ld for _, s, ld in check_word_ptxas),
          f"ptxas: K14's check_window spills (or was not reported): {check_word_ptxas}")
    dense_ptxas = ptxas_spills(ptxas_dense, ("dense_mv",))
    check(set(dense_ptxas) == {"dense_mv<false>", "dense_mv<true>"},
          f"ptxas: K12 reports {sorted(dense_ptxas)}")
    spilled = {k: v for k, v in dense_ptxas.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]}
    check(not spilled, f"ptxas: the dense kernel spills: {spilled}")
    # K10's one-launch step (scan_step), and the level passes (up,
    # top, down) and row differences, without spill (a gate).
    scan_ptxas = ptxas_spills(ptxas_scan, ("scan_step", "scan_pass", "row_diff"))
    check(set(scan_ptxas) == {"scan_step", "scan_pass", "row_diff"},
          f"ptxas: K10 reports {sorted(scan_ptxas)}")
    check(not (scan_ptxas["scan_step"]["spill_store_bytes"]
               or scan_ptxas["scan_step"]["spill_load_bytes"]),
          f"ptxas: K10's scan_step spills: {scan_ptxas['scan_step']}")
    scan_spills = [(lines[0], re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                        " ".join(lines)).groups())
                   for lines in ptxas_all(ptxas_scan, "scan_pass")]
    check(len(scan_spills) == 3 and all(g == ("0", "0") for _, g in scan_spills),
          f"ptxas: K10's scan passes spill (or were not reported): {scan_spills}")
    n_scan = tiny_scan_checks(torch, dev)
    # K15's two kernels, both selections, without spill (a gate), and
    # its first launches on every route bitwise its plain version.
    k15_ptxas = ptxas_spills(ptxas_explain, ("explain_cols", "explain_sparse", "explain_merge"))
    check(set(k15_ptxas) == {"explain_cols<true>", "explain_cols<false>",
                             "explain_sparse<true>", "explain_sparse<false>",
                             "explain_merge<true>", "explain_merge<false>"},
          f"ptxas: K15 reports {sorted(k15_ptxas)}")
    spilled = {k: v for k, v in k15_ptxas.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]}
    check(not spilled, f"ptxas: K15's kernels spill: {spilled}")
    n_k15 = tiny_k15_checks(torch, dev)
    n_fold = tiny_fold_checks(torch, fold, dev)
    n_k6 = tiny_k6_checks(torch, dev)
    n_dense = tiny_dense_checks(torch, dev)
    n_check = tiny_check_word_checks(torch, dev)
    step_cfg = step.kernel_config(dev)
    timers = timer_check(torch)
    return {
        "phase": "env",
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": power_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": {"nvcc_coo_spmv": round(cuda_s, 3),
                    "nvcc_pattern_pair": round(pattern_s, 3),
                    "nvcc_power_step": round(step_s, 3),
                    "nvcc_row_fold": round(fold_s, 3),
                    "nvcc_rank_setup": round(setup_s, 3),
                    "nvcc_rank_epilogue": round(epilogue_s, 3),
                    "nvcc_dense_mv": round(dense_s, 3),
                    "nvcc_csr_scan": round(scan_s, 3),
                    "nvcc_explain_epilogue": round(explain_s, 3),
                    "gxx_native": round(host_s, 3)},
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "ptxas" in ln],
        "ptxas_pattern_pair": [ln.strip() for ln in ptxas_pattern.splitlines()
                               if "ptxas" in ln],
        "ptxas_power_step": [ln.strip() for ln in ptxas_step.splitlines() if "ptxas" in ln],
        "ptxas_row_fold": [ln.strip() for ln in ptxas_fold.splitlines() if "ptxas" in ln],
        "ptxas_rank_setup": [ln.strip() for ln in ptxas_setup.splitlines() if "ptxas" in ln],
        "ptxas_rank_epilogue": [ln.strip() for ln in ptxas_epilogue.splitlines()
                                if "ptxas" in ln],
        # K6: the set-up's occupancy (blocks an SM of the grid form and
        # of the first design), the epilogue's limits (the largest
        # cluster this card holds), and every kernel's registers and
        # spill bytes (0: the gate).
        "setup_kernel": {**setup.kernel_config(dev)._asdict(),
                         "grid_blocks": setup.kernel_config(dev).grid_blocks,
                         "first_blocks": setup.kernel_config(dev).first_blocks},
        "epilogue_kernel": epilogue.kernel_config(dev)._asdict(),
        "k6_ptxas": k6_ptxas, "k6_spill_bytes": 0,
        # K12 (dense_mv<bf16>) and K14's check_window: registers and
        # spill bytes (0: the gates).
        "dense_ptxas": dense_ptxas, "dense_spill_bytes": 0,
        # K10: every scan pass and the row differences, registers and
        # spill bytes (0: the gate).
        "csr_scan_ptxas": [ln.strip() for ln in ptxas_scan.splitlines() if "ptxas" in ln],
        "csr_scan_step_ptxas": scan_ptxas["scan_step"],
        "csr_scan_spill_bytes": 0,
        "check_window_ptxas": check_word_ptxas,
        # K15: both kernels' selections, registers and spill bytes (0:
        # the gate).
        "k15_ptxas": k15_ptxas, "k15_spill_bytes": 0,
        # K5's fused kernel: each instantiation's ptxas lines
        # (registers, spills), the register slots a thread holds across
        # the barrier, and the occupancy that sizes every window's
        # cooperative grid.
        "step_kernel": {**step_cfg._asdict(), "max_blocks": step_cfg.max_blocks,
                        "ptxas": ptxas_all(ptxas_step, "step_grid"),
                        "group_ptxas": group_ptxas, "group_spill_bytes": 0},
        "tiny_launch_bitwise_vs_plain": tiny_bitwise,
        "tiny_pcsr_launches_bitwise_vs_plain": n_pcsr,
        "tiny_pattern_cases_bitwise_vs_plain": n_pattern,
        "tiny_step_chains_bitwise_vs_plain": n_step,
        "tiny_fold_cases_bitwise_vs_plain": n_fold,
        "tiny_k6_cases_bitwise_vs_plain": n_k6,
        "tiny_dense_cases_bitwise_vs_plain": n_dense,
        "tiny_check_word_cases_bitwise_vs_plain": n_check,
        "tiny_csr_scan_cases_bitwise_vs_plain": n_scan,
        "tiny_k15_cases_bitwise_vs_plain": n_k15,
        "timer_check_1gib_copy": timers,
    }


def phase_data(args, workdir):
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import SyntheticConfig, generate_case_with_spans

    t0 = time.perf_counter()
    case = generate_case_with_spans(
        SyntheticConfig(
            n_operations=args.ops,
            n_kinds=max(32, args.ops // 50),
            child_keep_prob=0.55,
            fault_latency_ms=60000.0,
            seed=0,
        ),
        target_spans=args.spans,
    )
    normal, abnormal = case.write_csvs(workdir)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # First load parses the CSVs and leaves the interned sidecars the
    # runs below reuse.
    n_normal = load_span_table(normal).n_spans
    n_abnormal = load_span_table(abnormal).n_spans
    return case, normal, abnormal, {
        "phase": "data",
        "spans_target": args.spans,
        "operations": args.ops,
        "normal_spans": n_normal,
        "abnormal_spans": n_abnormal,
        "fault_pod_op": case.fault_pod_op,
        "generate_write_s": round(gen_s, 3),
        "parse_s": round(time.perf_counter() - t0, 3),
    }


def graph_shapes(graph):
    out = {}
    for name in ("normal", "abnormal"):
        p = getattr(graph, name)
        out[name] = {
            "V": int(p.cov_unique.shape[0]),
            "T_pad": int(p.kind.shape[0]),
            "E_pad": int(p.inc_op.shape[0]),
            "E": int(p.n_inc),
            "C_pad": int(p.ss_child.shape[0]),
            "C": int(p.n_ss),
            "traces": int(p.n_traces),
            "cols": int(p.n_cols),
            "cov_bits_bytes": int(p.cov_bits.size),
        }
    return out


def device_ms(torch, fn, reps):
    """Device time per call of ``fn`` (kernels and copies it issues),
    from torch.profiler's CUDA activity; None when the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device time
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        total_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def rank_device_fields(rank_device, rank_wall_ms):
    """The rank program's device time by torch.profiler and by CUDA
    events around the program queued behind a long device spin (an upper
    bound: where its launches outrun the stream's queue, its tail may
    wait on the host), each with its share of the program's wall time;
    and the program whole as ``rank_program_event_ms`` (the events'
    time) beside ``rank_program_host_ms`` (the host's time to issue it,
    behind the same spin)."""
    prof, (events, host) = rank_device
    out = {}
    for key, t in (("rank_device_ms", prof), ("rank_device_event_ms", events)):
        out[key] = None if t is None else round(t, 4)
        share = key.replace("_ms", "_busy_share")
        out[share] = None if t is None else round(t / rank_wall_ms, 4)
    out["rank_program_event_ms"] = events
    out["rank_program_host_ms"] = host
    return out


def window_breakdown(torch, cfg, normal, abnormal, start_iso):
    """One ranked window again, through the lane's own seams, one stage
    at a time with the device drained between stages: where a window's
    wall time goes, and how busy the device is while the rank program
    runs. Returns (host graph, resolved kernel, stage ms, device ms of
    the rank stage)."""
    import numpy as np

    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )

    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(load_span_table(normal))
    table = load_span_table(abnormal)
    w0 = int(np.datetime64(start_iso, "us").astype(np.int64))
    w1 = w0 + int(cfg.window.detect_minutes * 60_000_000)
    ms = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    mask, nrm, abn, _, rng = stage("detect", lambda: rca._detect_window(table, w0, w1))
    graph, _, kernel = stage(
        "build", lambda: rca.prepare_rank(table, mask, nrm, abn, rng)
    )
    dgraph = stage("h2d", lambda: graph_from_numpy(host_subset(graph, kernel), rca.device))
    dgraph = stage("layouts", lambda: device_subset(dgraph, kernel))

    def rank():
        return rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)

    outs = stage("rank_issue_and_run", rank)
    stage("fetch", lambda: fetch_rank_outputs(outs))
    rank_device = (device_ms(torch, rank, 3),
                   spin_event_host_ms(torch, rank, 3, PROGRAM_SPIN_CYCLES))
    return graph, kernel, ms, rank_device, dgraph


def budget_inequalities(graph, budget):
    """The two inequalities of the auto policy at a window's real shapes:
    bitmaps within a quarter of the budget (else pcsr), unpacked f32
    matrices within the budget (else packed_blocked)."""
    from microrank_tpu_torch.graph.build import packed_bits_bytes, packed_unpacked_bytes

    v_pad = int(graph.normal.cov_unique.shape[0])
    t_pads = [int(p.kind.shape[0]) for p in (graph.normal, graph.abnormal)]
    bits = packed_bits_bytes(v_pad, t_pads)
    unpacked = packed_unpacked_bytes(v_pad, t_pads)
    return {
        "budget": budget, "v_pad": v_pad, "t_pads": t_pads,
        "bitmap_bytes": bits, "unpacked_bytes": unpacked,
        "bitmap_bytes <= budget/4": bits <= budget // 4,
        "unpacked_bytes <= budget": unpacked <= budget,
    }


def phase_run(torch, spmv, pattern, case, normal, abnormal, collapse, kernel,
              budget=None, want=None, precision="f32"):
    """One run of the lane with ``kernel`` ("pallas", or "auto" resolving
    to ``want``, by default AUTO_KERNEL[collapse]) at ``budget`` (None:
    the default dense budget) and ``precision`` (kind_precision) on the
    card and on the CPU. Returns (host graph, launch counts of the warm
    CUDA run, the CUDA run's results, info)."""
    from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    runtime = dict(kernel=kernel, collapse_kinds=collapse)
    if budget is not None:
        runtime["dense_budget_bytes"] = budget
    cfg = MicroRankConfig(
        pagerank=PageRankConfig(kind_precision=precision), runtime=RuntimeConfig(**runtime)
    )
    if want is None:
        want = kernel if kernel != "auto" else AUTO_KERNEL[collapse]
    int8 = precision == "int8" and want == "kind"
    tag = (f"kernel={kernel}, collapse={collapse}, precision={precision}, "
           f"budget={cfg.runtime.dense_budget_bytes}")
    walls, counts, res_gpu = [], [], None
    for _ in ("cold", "warm"):
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        res_gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(read_counts(spmv, pattern))

    t0 = time.perf_counter()
    res_cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0

    ranked = [r for r in res_gpu if r.ranking]
    check(ranked, f"{tag}: no window was ranked")
    kernels = sorted({r.kernel for r in ranked})
    check(kernels == [want], f"{tag}: ranked with {kernels}, want {want}")
    n = len(ranked)
    top1 = ranked[0].ranking[0][0]
    check(top1 == case.fault_pod_op, f"{tag}: top-1 {top1} is not the fault {case.fault_pod_op}")
    rtol = RUN_RTOL_BF16 if want == "packed_bf16" else RUN_RTOL
    # int8: the top-5 at JAX's own int8 gate (tests/test_kind_kernel.py).
    top_k, exempt_last = (5, True) if int8 else (None, False)
    if int8:
        rtol = RUN_RTOL_INT8
    check(len(res_cpu) == len(res_gpu), "CPU and CUDA runs saw different windows")
    for rg, rc in zip(res_gpu, res_cpu):
        check(
            (rg.start, rg.anomaly, rg.n_normal, rg.n_abnormal, rg.kernel)
            == (rc.start, rc.anomaly, rc.n_normal, rc.n_abnormal, rc.kernel),
            f"window {rg.start}: detection or kernel differs between CUDA and CPU runs",
        )
        ok, why = tie_aware_topk_agreement(
            [n_ for n_, _ in rg.ranking], [s for _, s in rg.ranking],
            [n_ for n_, _ in rc.ranking], [s for _, s in rc.ranking],
            k=top_k or len(rg.ranking), rtol=rtol, exempt_last=exempt_last,
        )
        check(ok, f"window {rg.start}: CUDA vs CPU ranking: {why}")
        check(rg.rank_iterations == rc.rank_iterations, "n_iters differ")
        if rg.ranking:
            check(rg.ranking[0][0] == rc.ranking[0][0], "top-1 differs between CUDA and CPU")

    graph, _, stages, rank_device, dgraph = window_breakdown(
        torch, cfg, normal, abnormal, ranked[0].start
    )
    expect = expected_counts(want, n, int8, folds=host_folds(pattern, graph))
    for c in counts:
        check(c == expect, f"{tag}: launch counts {c} in {n} ranked windows, want {expect}")
    # The window through the plain step on the card: bitwise.
    plain_step = plain_step_check(torch, dgraph, cfg, want)
    # K6 at this window: both kernels bitwise their plain versions, timed.
    k6 = measure_k6(torch, f"{tag}/k6", dgraph, cfg, want, K6_REPS)
    del dgraph
    rank_wall = stages["rank_issue_and_run"]
    return graph, counts[-1], res_gpu, {
        "phase": "run",
        "kernel": kernel,
        "resolved_kernel": want,
        "kind_precision": precision,
        "collapse_kinds": collapse,
        "dense_budget": budget_inequalities(graph, cfg.runtime.dense_budget_bytes),
        "windows": len(res_gpu),
        "ranked": n,
        "kind_dedup": ranked[0].kind_dedup,
        "shapes": graph_shapes(graph),
        "top5": ranked[0].ranking[:5],
        "top1_is_fault": True,
        "launches_per_run": counts,
        "k1_launches_per_ranked_window": counts[-1]["k1_launches"] // n,
        "k1_spmvs_per_ranked_window": counts[-1]["k1_spmvs"] // n,
        "pcsr_launches_per_ranked_window": counts[-1]["pcsr_launches"] // n,
        "pattern_launches_per_ranked_window": counts[-1]["pattern_launches"] // n,
        "quantize_launches_per_ranked_window": counts[-1]["quantize_launches"] // n,
        "step_launches_per_ranked_window": counts[-1]["step_launches"] // n,
        "cuda_vs_cpu_tie_aware": True,
        "cuda_vs_cpu_rtol": rtol,
        "cuda_vs_cpu_top_k": top_k or "all",
        "rank_iterations": ranked[0].rank_iterations,
        "cuda_wall_s_per_window": {
            "cold": round(walls[0] / len(res_gpu), 4),
            "warm": round(walls[1] / len(res_gpu), 4),
        },
        "cuda_window_timings_ms": ranked[0].timings,
        "stage_ms": stages,
        **rank_device_fields(rank_device, rank_wall),
        "plain_step": plain_step,
        "k6": k6,
        "cpu_wall_s": round(cpu_s, 4),
    }


def outputs_bitwise(a, b) -> bool:
    """Two fetched rank outputs (top_idx, top_scores, n_valid, residuals,
    n_iters) equal bit for bit."""
    import numpy as np

    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes() and
               np.shape(x) == np.shape(y) for x, y in zip(a, b))


def staging_compare(torch, spmv, pattern, tag, host, kernel, cfg, issue_reps=3):
    """Blob staging against the tree path on one host graph (already
    ``host_subset`` for ``kernel``; a stacked group's too), through
    ``rank_backends.blob.stage_rank_window`` (a group:
    ``stage_rank_windows_batched``) as the window loop calls it. First
    the blob's leaves decoded on the card, each fetched back: bitwise the
    host arrays, each at a 256-byte-aligned address. Then in turns (tree,
    blob, blob, tree): the staging timed (tree: the per-leaf H2D on the
    host clock, the device drained; blob: the pack on the host clock and
    the one copy by CUDA events), the program run and fetched, its
    outputs bitwise the first tree turn's and its launches the same; and
    the host's time from the staging to the start of the output copy
    with the device busy behind a ~100 ms spin (``issue_host_ms``: what
    the stage worker waits, the device drained after each call; the host
    pass that counts the layouts on the host graph, ``host_counts``, is
    in it, and timed apart as ``host_counts_ms``). Last, one staging,
    layouts, program and output copy under
    ``torch.cuda.set_sync_debug_mode("error")``, which must not raise on
    any route. The pack's first call (the pinned buffer's first
    allocation of its size) is reported apart."""
    import numpy as np

    from microrank_tpu_torch.graph.structures import PartitionGraph
    from microrank_tpu_torch.rank_backends import blob
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        fetch_rank_outputs,
        host_counts,
        pack_rank_outputs,
    )

    dev = torch.device("cuda")
    stacked = host.normal.kind.ndim == 2
    counts_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_counts(host, kernel)
        counts_ms.append((time.perf_counter() - t0) * 1e3)
    stage = blob.stage_rank_windows_batched if stacked else blob.stage_rank_window

    def issue(use_blob=True):
        return pack_rank_outputs(*stage(host, cfg.pagerank, cfg.spectrum, kernel, dev, use_blob,
                                        conv_trace=True))

    def program(use_blob):
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        outs, staged = stage(host, cfg.pagerank, cfg.spectrum, kernel, dev, use_blob,
                             conv_trace=True)
        fetched = fetch_rank_outputs(outs)
        del staged
        return fetched, read_counts(spmv, pattern)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf, layout = blob.pack_graph_blob(host, pin=True)
    pack_first_ms = (time.perf_counter() - t0) * 1e3
    check(buf.is_pinned(), f"{tag}: the blob is not in pinned memory")
    decoded = blob.unpack_graph_blob(buf.to(dev, non_blocking=True), layout)
    n_leaves = 0
    for name in ("normal", "abnormal"):
        for f in PartitionGraph._fields:
            a = np.asarray(getattr(getattr(host, name), f))
            b = getattr(getattr(decoded, name), f)
            got = b.cpu().numpy()
            check(got.shape == a.shape and got.dtype == a.dtype
                  and np.atleast_1d(got).tobytes() == np.atleast_1d(a).tobytes(),
                  f"{tag}: leaf {name}.{f} decoded on the card is not the host array")
            check(b.numel() == 0 or b.data_ptr() % blob.ALIGN_BYTES == 0,
                  f"{tag}: leaf {name}.{f} is not {blob.ALIGN_BYTES}-byte aligned")
            n_leaves += 1
    n_bytes = buf.numel()
    del decoded, buf
    tree_bytes = int(sum(np.asarray(a).nbytes for part in (host.normal, host.abnormal)
                         for a in part))
    turns, ref = [], None
    for mode in ("tree", "blob", "blob", "tree"):
        torch.cuda.synchronize()
        turn = {"mode": mode}
        if mode == "tree":
            t0 = time.perf_counter()
            g = graph_from_numpy(host, dev)
            torch.cuda.synchronize()
            turn["h2d_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            del g
        else:
            t0 = time.perf_counter()
            buf, _ = blob.pack_graph_blob(host, pin=True)
            turn["pack_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            card = buf.to(dev, non_blocking=True)
            stop.record()
            torch.cuda.synchronize()
            turn["copy_ms"] = round(start.elapsed_time(stop), 4)
            turn["copy_gb_per_s"] = round(n_bytes / turn["copy_ms"] / 1e6, 2)
            del card, buf
        out, launches = program(mode == "blob")
        if ref is None:
            ref = (out, launches)
        check(outputs_bitwise(out, ref[0]),
              f"{tag}: the {mode} turn's outputs are not bitwise the tree path's")
        check(launches == ref[1], f"{tag}: {mode} launches {launches}, tree {ref[1]}")
        event_ms, host_ms = spin_event_host_ms(
            torch, lambda: issue(mode == "blob"), issue_reps, PROGRAM_SPIN_CYCLES, settle=True)
        turn["issue_host_ms"] = round(host_ms, 3)
        turn["staged_program_event_ms"] = round(event_ms, 4)
        turns.append(turn)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = issue()
    except RuntimeError as exc:
        raise PhaseError(f"{tag}: the {kernel} route synced between its blob copy and its "
                         f"output copy: {str(exc).splitlines()[0]}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    from microrank_tpu_torch.rank_backends.torch_cuda import unpack_rank_outputs

    check(outputs_bitwise(unpack_rank_outputs(packed), ref[0]),
          f"{tag}: the run under the sync check differs from the tree path's")

    def med(key):
        return _median([t[key] for t in turns if key in t])

    return {
        "kernel": kernel,
        "stacked_windows": int(host.normal.kind.shape[0]) if stacked else None,
        "leaves": n_leaves,
        "leaves_bitwise_on_card": True,
        "leaves_aligned_bytes": blob.ALIGN_BYTES,
        "blob_bytes": n_bytes,
        "tree_bytes": tree_bytes,
        "pack_first_ms": round(pack_first_ms, 3),
        "host_counts_ms": round(_median(counts_ms), 3),
        "turns": turns,
        "pack_ms": med("pack_ms"),
        "copy_ms": med("copy_ms"),
        "tree_h2d_ms": med("h2d_ms"),
        "issue_host_ms": {"blob": _median([t["issue_host_ms"] for t in turns
                                           if t["mode"] == "blob"]),
                          "tree": _median([t["issue_host_ms"] for t in turns
                                           if t["mode"] == "tree"])},
        "outputs_bitwise_vs_tree": True,
        "launches": ref[1],
        "launches_equal_tree": True,
        "issues_without_host_sync": True,
    }


# The config-5 routes of the staging phase: (phase_run's graph, kernel,
# kind_precision).
STAGING_ROUTES = (
    ("auto/auto", "kind", "f32"),
    ("auto/int8", "kind", "int8"),
    ("auto/off", "packed_bf16", "f32"),
    ("auto/off", "packed", "f32"),
    ("pallas/auto", "pallas", "f32"),
    ("pallas/off", "pallas", "f32"),
    ("auto/packed_blocked", "packed_blocked", "f32"),
    ("auto/pcsr", "pcsr", "f32"),
)


def phase_staging(torch, spmv, pattern, graphs):
    """Blob staging against the tree path on every config-5 route
    (``staging_compare``: the leaves on the card, the outputs, launches
    and staging times in turns, the stage worker's host time behind a
    spin, the sync check)."""
    from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig
    from microrank_tpu_torch.rank_backends.torch_cuda import host_subset

    routes = {}
    for key, kernel, precision in STAGING_ROUTES:
        cfg = MicroRankConfig(pagerank=PageRankConfig(kind_precision=precision))
        name = f"{key}:{kernel}" + ("" if precision == "f32" else f":{precision}")
        routes[name] = staging_compare(torch, spmv, pattern, f"staging/{name}",
                                       host_subset(graphs[key], kernel), kernel, cfg)
    return {"phase": "staging", "routes": routes, "nvidia_smi": power_line()}


def phase_replay_data(args, workdir):
    """bench.py's config-5 replay (``_ensure_batch_data``): every window
    faulted, from the port's own timeline generator, written and parsed
    as a user's dump would be. The timeline CSV is written one window at
    a time (the same bytes as one write), and the file's size after each
    window is kept: the follow phase grows its file by those byte
    ranges."""
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline_with_spans
    from microrank_tpu_torch.testing.synthetic import write_spans_csv

    n = args.replay_windows
    t0 = time.perf_counter()
    tl = generate_timeline_with_spans(
        SyntheticConfig(
            n_operations=args.ops,
            n_kinds=max(32, args.ops // 50),
            child_keep_prob=0.55,
            fault_latency_ms=60000.0,
            seed=0,
        ),
        args.spans,
        n,
        list(range(n)),  # every window carries the fault
    )
    (workdir / "replay").mkdir()
    normal, abnormal = workdir / "replay" / "normal.csv", workdir / "replay" / "abnormal.csv"
    write_spans_csv(tl.normal, normal, tl.n_operations)
    offsets = []
    for i, window in enumerate(tl.windows):
        write_spans_csv(window, abnormal, tl.n_operations, append=i > 0)
        offsets.append(abnormal.stat().st_size)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    normal_table = load_span_table(normal, cache=False)
    table = load_span_table(abnormal, cache=False)
    return tl, normal_table, table, (abnormal, offsets), {
        "windows": n,
        "spans_per_window_target": args.spans,
        "timeline_spans": table.n_spans,
        "normal_spans": normal_table.n_spans,
        "generate_write_s": round(gen_s, 3),
        "parse_s": round(time.perf_counter() - t0, 3),
    }


def kernel_busy_share(torch, workdir, fn):
    """Run ``fn`` once under torch.profiler (device activity only) and
    return (wall s, union of the kernel intervals over that wall time);
    the share is None when the profiler recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile

    trace = workdir / "replay_trace.json"
    for _ in range(3):  # the profiler now and then records no device time
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(trace))
        spans = sorted(
            (e["ts"], e["ts"] + e["dur"])
            for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") == "kernel"
        )
        trace.unlink()
        if spans:
            busy_us, end = 0.0, float("-inf")
            for lo, hi in spans:
                busy_us += max(0.0, hi - max(lo, end))
                end = max(end, hi)
            return wall, busy_us / 1e6 / wall
    return wall, None


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _mean(values):
    return sum(values) / len(values)


def replay_config(tl, precision="f32", **runtime):
    """The replay's config: each generated window exactly (detect = its
    span, skip = 0), kind_precision ``precision``."""
    from microrank_tpu_torch.config import (
        MicroRankConfig,
        PageRankConfig,
        RuntimeConfig,
        WindowConfig,
    )

    return MicroRankConfig(
        window=WindowConfig(detect_minutes=tl.window_minutes, skip_minutes=0.0),
        pagerank=PageRankConfig(kind_precision=precision),
        runtime=RuntimeConfig(**runtime),
    )


def metrics_gates(tag, out, n_ranked, admitted, windows):
    """The metrics a run wrote, read back as ``cli stats`` reads them:
    ``metrics.json`` in ``out`` holds the ranked windows, one convergence
    sample per ranked window and the admitted rows, and the journal's
    ``run_end`` carries ``telemetry``; the run's span ring (the process
    tracer the run armed) holds ``microrank_spans_recorded_total`` spans,
    none dropped, each in the ``win-<start>`` trace of a window of the
    run (``windows``: the run's window starts)."""
    from microrank_tpu_torch.obs import JOURNAL_NAME, get_tracer, read_journal

    snap = json.loads((out / "metrics.json").read_text())["metrics"]

    def samples(name):
        return snap[name]["samples"]

    ranked = sum(s["value"] for s in samples("microrank_windows_total")
                 if s["labels"]["outcome"] == "ranked")
    iters = sum(s["count"] for s in samples("microrank_rank_iterations"))
    admitted_rows = sum(s["value"] for s in samples("microrank_ingest_admitted_total"))
    check(ranked == n_ranked, f"{tag}: windows_total ranked {ranked}, want {n_ranked}")
    check(iters == n_ranked, f"{tag}: rank_iterations count {iters}, want {n_ranked}")
    check(admitted_rows == admitted,
          f"{tag}: ingest admitted {admitted_rows}, admit_table kept {admitted}")
    blob_transfers = sum(s["value"] for s in samples("microrank_staging_transfers_total")
                         if s["labels"]["path"] == "blob")
    check(blob_transfers == n_ranked,
          f"{tag}: staging_transfers_total{{path=blob}} {blob_transfers}, want {n_ranked}")
    end = read_journal(out / JOURNAL_NAME)[-1]
    check(end["event"] == "run_end" and "telemetry" in end,
          f"{tag}: the journal's run_end has no telemetry")
    tracer = get_tracer()
    spans = tracer.snapshot()
    recorded = sum(s["value"] for s in samples("microrank_spans_recorded_total"))
    check(tracer.enabled and recorded == len(spans) == tracer.recorded > 0,
          f"{tag}: spans_recorded_total {recorded}, {len(spans)} spans in the ring")
    traces = {f"win-{w}" for w in windows}
    strays = sorted({s.trace_id for s in spans} - traces)
    check(not strays, f"{tag}: spans outside the run's window traces: {strays[:3]}")
    return {
        "spans_recorded": recorded,
        "span_names": sorted({s.name for s in spans}),
        "windows_total_ranked": ranked,
        "rank_iterations_count": iters,
        "ingest_admitted": admitted_rows,
        "staging_transfers_blob": blob_transfers,
        "run_end_telemetry": end["telemetry"],
        "series_sampled": sorted(k for k, v in snap.items() if v["samples"]),
    }


def ranked_timings(results):
    """The first ranked window's timings (batch's shared keys)."""
    return next((r.timings for r in results if r.ranking), {})


def ranking_agreement(a, b, rtol, int8=False):
    """Two rankings [(name, score), ...] tie-aware at ``rtol``, the same
    length and top-1; ``int8``: the top-5 at RUN_RTOL_INT8, the last
    place exempt (JAX's own int8 gate, as phase_run's)."""
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    if len(a) != len(b) or (a and a[0][0] != b[0][0]):
        return False, "lengths or top-1 differ"
    return tie_aware_topk_agreement(
        [n for n, _ in a], [x for _, x in a], [n for n, _ in b], [x for _, x in b],
        k=min(5, len(a)) if int8 else len(a), rtol=RUN_RTOL_INT8 if int8 else rtol,
        exempt_last=int8,
    )


def replay_groups(mode, n):
    """The sizes of the stacked groups a replay mode ranks ``n`` windows
    in: all of them in one (batch), groups of dispatch_batch_windows, or
    one program a window."""
    if mode == "batch":
        return [n]
    k = REPLAY_MODES[mode].get("dispatch_batch_windows", 1)
    return [min(k, n - i) for i in range(0, n, k)]


def replay_mode(torch, spmv, pattern, tl, normal_table, table, mode, workdir):
    """One mode of ``TableRCA.run`` on the card over the whole timeline:
    a warm pass with a sink (records, cursor, journal; in the default
    mode also the metrics snapshot the CLI writes, into a fresh registry,
    and its gates), three timed passes without one (as bench.py's
    ``_run_replay``), their launches counted per pass (a stacked mode's
    per group: 25 launches of each kernel a group), then one pass under
    the profiler for the device's busy share. Returns (rca, warm
    results, launch counts of the last timed pass, info)."""
    import numpy as np

    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.graph.table_ops import window_rows
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.graph.structures import PartitionGraph
    from microrank_tpu_torch.obs import JOURNAL_NAME, MetricsRegistry, read_journal, set_registry
    from microrank_tpu_torch.obs.metrics import ensure_catalog, staging_transfers
    from microrank_tpu_torch.pipeline import TableRCA

    precision = REPLAY_PRECISION.get(mode, "f32")
    cfg = replay_config(tl, precision, **REPLAY_MODES[mode])
    tag = f"replay/{mode}"
    batch = mode == "batch"
    with_metrics = mode == "default"
    # Every mode's warm pass records into a fresh registry: its staging
    # counts are gated below.
    registry = MetricsRegistry()
    set_registry(registry)
    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(normal_table)

    streams = []
    entry = "launch_program" if mode in STACKED_MODES else "launch_rank"
    launch = getattr(rca, entry)

    def spy(*a):  # which stream the launch issues on, once
        streams.append(torch.cuda.current_stream())
        setattr(rca, entry, launch)
        return launch(*a)

    setattr(rca, entry, spy)
    out = workdir / f"replay_{mode}"
    warm = rca.run(table, out_dir=out, batch_windows=batch)
    # One staging transfer a program (a window, or a stacked group) on
    # the blob path, one a leaf on the tree path.
    n_programs = len(replay_groups(mode, sum(1 for r in warm if r.ranking)))
    transfers = {path: staging_transfers().value(path=path) for path in ("blob", "tree")}
    want = ({"blob": 0, "tree": n_programs * 2 * len(PartitionGraph._fields)}
            if not cfg.runtime.blob_staging else {"blob": n_programs, "tree": 0})
    check(transfers == want, f"{tag}: staging transfers {transfers}, want {want}")
    metrics = None
    if with_metrics:
        # What `cli run` writes beside the results when telemetry is on.
        ensure_catalog()
        registry.write_snapshot(out)
        kept = sum(admit_table(t, IngestConfig())[0].n_spans for t in (normal_table, table))
        metrics = metrics_gates(tag, out, sum(1 for r in warm if r.ranking), kept,
                                [r.start for r in warm])
    set_registry(MetricsRegistry())
    check(len(streams) == 1, f"{tag}: {entry} was not reached")
    on_default = streams[0] == torch.cuda.default_stream()
    if cfg.runtime.async_dispatch and not batch:  # batch ranks after the loop's workers
        check(not on_default, f"{tag}: the stage worker launched on the default stream")
    ranked = [r for r in warm if r.ranking]
    check(len(ranked) == len(tl.windows),
          f"{tag}: {len(ranked)} of {len(tl.windows)} faulted windows ranked")
    check(all(r.skipped_reason == "empty_window" for r in warm if not r.ranking),
          f"{tag}: an unranked window that is not empty")
    for r in ranked:
        check(r.ranking[0][0] == tl.fault_pod_op,
              f"{tag}: window {r.start} top-1 {r.ranking[0][0]} is not {tl.fault_pod_op}")
        check(r.kernel == "kind", f"{tag}: window {r.start} ranked with {r.kernel}")
    check(not (out / "cursor.json").exists(), f"{tag}: a clean run left its cursor")
    events = read_journal(out / JOURNAL_NAME)
    n_win = sum(e["event"] == "window" for e in events)
    check(n_win == len(warm), f"{tag}: {n_win} journal window events for {len(warm)} windows")
    check([e["event"] for e in events[:1] + events[-1:]] == ["run_start", "run_end"],
          f"{tag}: the journal does not open with run_start and close with run_end")

    n = len(ranked)
    groups = replay_groups(mode, n)
    expect = expected_counts("kind", n, int8=precision == "int8", programs=len(groups),
                             groups=sum(1 for g in groups if g > 1))
    if mode in STACKED_MODES:
        check([r.timings.get("chunk_windows", n) for r in ranked]
              == [g for g in groups for _ in range(g)],
              f"{tag}: windows not ranked in groups of {groups}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, timed, stage_sums = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        res = rca.run(table, batch_windows=batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts(spmv, pattern)
        check(counts == expect, f"{tag}: launch counts {counts} in {n} ranked windows, want {expect}")
        check([(r.start, r.ranking, r.rank_iterations) for r in res]
              == [(r.start, r.ranking, r.rank_iterations) for r in warm],
              f"{tag}: a timed pass differs from the warm pass")
        timed.extend(res)
        # The main thread's per-window stages (batch's shared build and
        # rank counted once); the rest of a pass is per-run work
        # (admission of the whole table, its bounds).
        shared = {"build", "rank_batched"}
        stage_sums.append(sum(
            v for r in res for k, v in r.timings.items()
            if not k.endswith("_windows") and k not in shared
        ) + sum(v for k, v in ranked_timings(res).items() if k in shared))
    peak = torch.cuda.max_memory_allocated()
    prof_wall, busy = kernel_busy_share(
        torch, workdir, lambda: rca.run(table, batch_windows=batch)
    )

    replay_s = _median(walls)
    median_pass = walls.index(replay_s)
    spans = sum(
        int(window_rows(table, int(np.datetime64(r.start, "us").astype(np.int64)),
                        int(np.datetime64(r.end, "us").astype(np.int64))).sum())
        for r in ranked
    )
    keys = ("detect", "rank_dispatch", "rank_wait", "bulk_fetch_ms", "chunk_fetch_ms",
            "build", "rank_batched")
    medians = {
        k: _median([r.timings[k] for r in timed if r.ranking and k in r.timings])
        for k in keys
    }
    return rca, warm, counts, {
        "mode": mode,
        "runtime": REPLAY_MODES[mode],
        "kind_precision": precision,
        "windows": len(warm),
        "ranked": n,
        "top1_is_fault": True,
        "kernel": "kind",
        "spans_ranked": spans,
        "replay_ms": round(replay_s * 1e3, 3),
        "replay_ms_passes": [round(w * 1e3, 3) for w in walls],
        "window_stage_ms_sum": round(stage_sums[median_pass], 3),
        "ms_per_window": round(replay_s * 1e3 / n, 3),
        "spans_per_s": round(spans / replay_s, 1),
        "device_busy_share": None if busy is None else round(busy, 4),
        "profiled_pass_ms": round(prof_wall * 1e3, 3),
        "peak_device_memory_bytes": peak,
        "window_timing_medians_ms": {k: v for k, v in medians.items() if v is not None},
        "queue_depths": [r.queue_depth for r in warm if r.ranking],
        "groups": groups,
        "launches_per_pass": counts,
        "stage_stream_is_default": on_default,
        "staging_transfers": transfers,
        "metrics": metrics,
    }


def replay_staging_turns(torch, rcas, table, n_windows, rounds=3):
    """The default mode (blob staging) and the tree mode (``--no-blob-
    staging``) in turns, ``rounds`` times (default, tree, tree, default):
    each pass's ms per window and the stage worker's host ms per window
    from the staging to the start of the output copy (``launch_program``
    timed on the stage worker's thread); per mode the medians over the
    passes, and how many of the turns' pairs the default won."""
    passes = []
    for mode in ("default", "tree", "tree", "default") * rounds:
        rca, times = rcas[mode], []
        launch = rca.launch_program

        def timed(*a, launch=launch, times=times):
            t0 = time.perf_counter()
            out = launch(*a)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        rca.launch_program = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rca.run(table)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rca.launch_program = launch
        check(len(times) == n_windows, f"replay/{mode}: {len(times)} launches, {n_windows} windows")
        passes.append({
            "mode": mode,
            "ms_per_window": round(wall * 1e3 / n_windows, 3),
            "stage_worker_host_ms": [round(t, 3) for t in times],
        })

    def of(mode, key):
        return [x for q in passes if q["mode"] == mode
                for x in (q[key] if isinstance(q[key], list) else [q[key]])]

    # Each adjacent pair of passes, (default, tree) or (tree, default).
    pairs = [{q["mode"]: q["ms_per_window"] for q in passes[i:i + 2]}
             for i in range(0, len(passes), 2)]
    return {
        "passes": passes,
        "ms_per_window_median": {m: _median(of(m, "ms_per_window")) for m in ("default", "tree")},
        "stage_worker_host_ms_median": {m: _median(of(m, "stage_worker_host_ms"))
                                        for m in ("default", "tree")},
        "pairs_default_faster": sum(q["default"] < q["tree"] for q in pairs),
        "pairs": len(pairs),
    }


def replay_span_turns(torch, tl, normal_table, table, n_windows):
    """The default mode with the span tracer on (the default) and off
    (``--no-span-trace``) in turns (on, off, off, on): ms per window of
    each pass and the spans the pass recorded. JAX's acceptance is
    "within 5% of spans-disabled"; the replay's spread across runs is
    wider than that, so it is reported, not gated."""
    from microrank_tpu_torch.config import ObsConfig
    from microrank_tpu_torch.obs import get_tracer
    from microrank_tpu_torch.pipeline import TableRCA

    cfg = replay_config(tl)
    rcas = {}
    for mode, obs in (("on", ObsConfig()), ("off", ObsConfig(spans=False))):
        rcas[mode] = TableRCA(cfg.replace(obs=obs), device="cuda")
        rcas[mode].fit_baseline(normal_table)
        rcas[mode].run(table)  # warm
    passes = []
    for mode in ("on", "off", "off", "on"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rcas[mode].run(table)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        passes.append({"spans": mode, "ms_per_window": round(wall * 1e3 / n_windows, 3),
                       "spans_recorded": get_tracer().recorded})
    check(all((q["spans_recorded"] > 0) == (q["spans"] == "on") for q in passes),
          "replay: the span tracer recorded with --no-span-trace, or nothing without it")
    med = {m: _median([q["ms_per_window"] for q in passes if q["spans"] == m])
           for m in ("on", "off")}
    return {"passes": passes, "ms_per_window_median": med,
            "on_over_off": round(med["on"] / med["off"], 4)}


def phase_replay(torch, spmv, pattern, args, workdir):
    """The replay phase: ``TableRCA.run`` over bench.py's config-5
    timeline in the sync, default (async stream, depth 2) and async bulk
    modes, each held bitwise to the sync run, and a run resumed from a
    cursor saved after window 2 held bitwise to the tail."""
    from microrank_tpu_torch.pipeline.checkpoint import WindowCursor

    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.pipeline import TableRCA

    t0 = time.perf_counter()
    tl, normal_table, table, timeline_csv, data = phase_replay_data(args, workdir)
    # What every run() does once before its first window: admission of
    # the whole timeline table.
    admit_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        admit_table(table, IngestConfig(), source="table")
        admit_ms.append((time.perf_counter() - t1) * 1e3)
    launches, infos, warm, records, rcas = {}, {}, {}, {}, {}
    for mode in REPLAY_MODES:
        rcas[mode], res, counts, info = replay_mode(
            torch, spmv, pattern, tl, normal_table, table, mode, workdir
        )
        launches[f"replay/{mode}"] = counts
        infos[mode], warm[mode] = info, res
        lines = (workdir / f"replay_{mode}" / "windows.jsonl").read_text().splitlines()
        records[mode] = [
            {k: rec.get(k) for k in ("start", "anomaly", "skipped_reason", "ranking")}
            for rec in map(json.loads, lines)
        ]
    rca = rcas["default"]
    ref = [(r.start, r.ranking, r.rank_iterations) for r in warm["sync"]]
    for mode in ("default", "bulk", "tree"):
        got = [(r.start, r.ranking, r.rank_iterations) for r in warm[mode]]
        check(got == ref, f"replay/{mode}: rankings are not bitwise the sync run's")
        check(records[mode] == records["sync"],
              f"replay/{mode}: windows.jsonl records differ from the sync run's")
    # The per-window int8 run (sync) that the int8 chunked mode is held to.
    int8_rca = TableRCA(replay_config(tl, "int8", **REPLAY_MODES["sync"]), device="cuda")
    int8_rca.fit_baseline(normal_table)
    int8_ref = int8_rca.run(table)
    # The stacked modes: the same windows, iterations and top-1, the
    # rankings tie-aware at rtol 1e-5 (int8: the top-5 at its gate)
    # against the sync run of their precision; whether they are bitwise
    # is reported (a stacked window's preference sums run over the
    # group's padded trace axis).
    for mode in STACKED_MODES:
        got = warm[mode]
        int8 = REPLAY_PRECISION.get(mode) == "int8"
        base = int8_ref if int8 else warm["sync"]
        check([(r.start, r.rank_iterations) for r in got]
              == [(r.start, r.rank_iterations) for r in base],
              f"replay/{mode}: windows or iterations differ from the per-window run's")
        for a, b in zip(got, base):
            ok, why = ranking_agreement(a.ranking, b.ranking, RUN_RTOL, int8)
            check(ok, f"replay/{mode}: window {a.start}: {why}")
        strip = [{k: v for k, v in rec.items() if k != "ranking"} for rec in records[mode]]
        check(strip == [{k: v for k, v in rec.items() if k != "ranking"}
                        for rec in records["sync"]],
              f"replay/{mode}: windows.jsonl records differ from the sync run's")
        infos[mode]["rankings_bitwise_vs_per_window"] = (
            [(r.start, r.ranking, r.rank_iterations) for r in got]
            == [(r.start, r.ranking, r.rank_iterations) for r in base]
        )
        infos[mode]["rankings_tie_aware_vs_per_window"] = (
            "top-5 at 5e-2 (int8)" if int8 else "all at 1e-5")
        infos[mode]["per_window_run"] = "sync int8" if int8 else "sync"
    int8_one = [r for r in int8_ref if r.ranking]
    check(all(r.kernel == "kind" and r.ranking[0][0] == tl.fault_pod_op for r in int8_one),
          "replay: the per-window int8 run does not rank every window with kind, fault first")

    n_ranked = sum(1 for r in warm["sync"] if r.ranking)
    staging_turns = replay_staging_turns(torch, rcas, table, n_ranked)
    span_turns = replay_span_turns(torch, tl, normal_table, table, n_ranked)
    # Resume (default mode): a cursor saved after window 2 reruns the rest.
    k = min(2, len(warm["sync"]) - 1)
    out = workdir / "replay_resume"
    WindowCursor(out / "cursor.json").save(warm["sync"][k].start)
    resumed = rca.run(table, out_dir=out, resume=True)
    check([(r.start, r.ranking, r.rank_iterations) for r in resumed] == ref[k:],
          f"replay: the run resumed after window {k} is not bitwise windows {k + 1}-")
    return (tl, normal_table, table, timeline_csv), warm["sync"], launches, {
        "phase": "replay",
        "data": data,
        "fault_pod_op": tl.fault_pod_op,
        "admit_table_ms": round(_median(admit_ms), 3),
        "modes": infos,
        "rankings_bitwise_vs_sync": True,  # default, bulk, tree; the stacked modes' in modes
        "sink_records_equal": True,
        "resumed_after_window": k,
        "resumed_bitwise": True,
        "staging_turns": staging_turns,
        "span_turns": span_turns,
        "phase_s": round(time.perf_counter() - t0, 3),
    }


def stacked_kernel_checks(torch, spmv, pattern, tag, card, host, singles=None,
                          precision="f32"):
    """One step's window-axis kernels of a stacked group, on random
    inputs: K1 over the stacked work list (pallas), the pcsr step over
    its work list and its slabs of B windows' rows (pcsr), or the pattern
    pair's window grid (kind, packed; K8 and its fold for packed_blocked;
    int8 after ``quantize_amax``'s [B, 4] scales) then K1 over the
    call-graph terms, bitwise their plain versions (computed on the CPU
    from ``host``, the same group built there; or, with ``singles``, the
    group's windows launched one by one, whose kernels other phases hold
    to the plain version), then bitwise over 50 launches with every
    arrival counter and amax slot back at 0. Returns the fields of the
    report."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b = card.normal.kind.shape[0]
    dev = torch.device("cuda")
    svs = [torch.rand((b, p.cov_unique.shape[-1]), generator=gen, device=dev)
           for p in (card.normal, card.abnormal)]
    rvs = [torch.rand((b, p.kind.shape[-1]), generator=gen, device=dev)
           for p in (card.normal, card.abnormal)]
    pair = card.pattern_group
    pcsr = isinstance(card.spmv_group, spmv.PcsrGroup)
    prec = "bf16" if tag.endswith("packed_bf16") else precision

    def launch(g, r, v):
        """The step's kernels of group (or window) ``g`` on (rvs, svs)."""
        if g.pattern_group is None:
            six = spmv.pcsr_spmv_group if pcsr else spmv.coo_spmv_group
            return list(six(g.spmv_group, (r[0], v[0], r[1], v[1])))
        scales = pattern.quantize_scales(g.pattern_group, r, v) if prec == "int8" else None
        outs = pattern.pattern_pair_group(g.pattern_group, r, v, prec, scales)
        xs = [sv if x is None else x for sv, (_, _, x) in zip(v, outs)]
        return ([] if scales is None else [scales]) + [
            t for o in outs for t in o if t is not None] + list(
            spmv.coo_spmv_group(g.spmv_group, xs))

    first = [t.clone() for t in launch(card, rvs, svs)]
    torch.cuda.synchronize()
    if singles is None:
        want = launch(host, [x.cpu() for x in rvs], [x.cpu() for x in svs])
    else:
        rows = [launch(one, [x[w].contiguous() for x in rvs], [x[w].contiguous() for x in svs])
                for w, one in enumerate(singles)]
        want = [torch.stack([row[i] for row in rows]) for i in range(len(rows[0]))]
    torch.cuda.synchronize()
    diffs = [float((a.cpu() - w.cpu()).abs().max()) if a.numel() else 0.0
             for a, w in zip(first, want)]
    bitwise = all(torch.equal(bits(torch, a.cpu()), bits(torch, w.cpu()))
                  for a, w in zip(first, want))
    check(bitwise, f"{tag}: a window-axis kernel differs from its plain version")
    for _ in range(REPEATS):
        again = launch(card, rvs, svs)
        check(all(torch.equal(bits(torch, a), bits(torch, f)) for a, f in zip(again, first)),
              f"{tag}: not bitwise repeatable over {REPEATS} launches")
    torch.cuda.synchronize()
    work = card.spmv_group.rows if pcsr else card.spmv_group
    check(not bool(work.counters.any()), f"{tag}: K1's counters left non-zero")
    check(pair is None or not any(bool(p.counters.any()) for p in pair.parts),
          f"{tag}: the pair's counters left non-zero")
    check(pair is None or not bool(pair.amax_scratch.any()),
          f"{tag}: quantize_amax left its scratch non-zero")
    return {
        "kernels_bitwise_plain": True,
        "plain_from": "cpu" if singles is None else "the windows one by one",
        "kernels_repeatable": REPEATS,
        "max_abs_err": max(diffs),
    }


def program_bound(spmv, card, int8=False):
    """(bytes, bytes ms) of a rank program's 25 steps on a staged graph
    (one window or a stacked group): per step the bytes its kernels must
    move, each input read once and each output written once, at 3.35
    TB/s: K1's or the pcsr step's live entries (column and value), x read
    and y written; the ELL slabs' live entries, x and y; the pattern
    pairs' bitmaps [V, ceil(K/8)] with their vectors (``pattern_bound``'s
    bytes, no set-cell count needed); K5's products, pref and carry
    (``step_bound``); int8's four scales. The set-up, the epilogue and
    the first step's scale launch are left out (once a program)."""
    b = card.normal.kind.shape[0] if card.normal.kind.dim() == 2 else 1
    group = card.spmv_group
    work = group.rows if isinstance(group, spmv.PcsrGroup) else group
    live = int((work.items[:, 3] - work.items[:, 2]).sum())
    nbytes = 8 * live + 4 * sum(work.n_x) + 4 * sum(work.n_rows)
    if isinstance(group, spmv.PcsrGroup):
        for e in group.ell:
            n = int((e.vals != 0).sum())
            nbytes += 8 * n + 4 * b * card.normal.cov_unique.shape[-1] + 4 * e.ops.shape[0]
    if card.pattern_group is not None:
        nbytes += b * pattern_bound(card.pattern_group, [0] * len(card.pattern_group.parts))[0]
        nbytes += 16 * b if int8 else 0
    sizes = [(int(p.cov_unique.shape[-1]), int(p.kind.shape[-1]))
             for p in (card.normal, card.abnormal)]
    nbytes += b * step_bound(sizes)[0]
    total = STEPS * nbytes
    return total, total / HBM_BYTES_PER_S * 1e3


def k6_bitwise(torch, tag, dgraph, cfg, kernel):
    """K6's set-up and epilogue at a staged window's (or group's) shapes,
    the epilogue on its program's final carries: each bitwise its plain
    version and the first design's kernel on the card (not timed)."""
    from microrank_tpu_torch.ops import epilogue, setup
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    pr, sp = cfg.pagerank, cfg.spectrum
    g_n, g_a = dgraph.normal, dgraph.abnormal
    want = setup_bits(torch, setup.rank_setup_plain(g_n, g_a, pr))
    for first in (False, True):
        check(torch.equal(setup_bits(torch, setup.rank_setup(g_n, g_a, pr, first_design=first)),
                          want), f"{tag}: K6's set-up (first design: {first}) differs from its "
                                 "plain version")
    program = tc._rank_program(dgraph, pr, sp, kernel)
    svs = (program.sv_n, program.sv_a)
    want = epilogue_bits(torch, epilogue.rank_epilogue_plain(g_n, g_a, *svs, sp))
    for first in (False, True):
        check(torch.equal(epilogue_bits(torch, epilogue.rank_epilogue(
            g_n, g_a, *svs, sp, first_design=first)), want),
            f"{tag}: K6's epilogue (first design: {first}) differs from its plain version")
    return True


def stacked_program(torch, spmv, pattern, tag, card, singles, kernel, cfg, timed=True):
    """The stacked rank program (K18) on the card, as the lane issues a
    group: its launches counted (25 of each kernel of the route for the
    whole group; int8 one scale launch), its outputs held to each
    window's own program (the same n_valid and n_iters, the ranking
    tie-aware at rtol 1e-5, int8 the top-5 at 5e-2; bitwise reported),
    its steps (K5's group kernel, int8 with its [B, 4] scales) through
    the plain step on the card bitwise (``plain_step_check``); with
    ``timed``, host issue and device
    time (CUDA events behind a ~100 ms spin, the device drained after
    each call) of the stacked program and of the windows' own programs,
    each window's timed alone and the B summed, in turns (windows,
    stacked, stacked, windows), per program and per window."""
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    b = len(singles)

    def program(dg):
        return lambda: tc.pack_rank_outputs(
            tc.rank_window_traced_core(dg, cfg.pagerank, cfg.spectrum, kernel))

    program(card)()
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    packed = program(card)()
    torch.cuda.synchronize()
    counts = read_counts(spmv, pattern)
    int8 = kernel == "kind" and cfg.pagerank.kind_precision == "int8"
    folds = card.pattern_group is not None and pattern.blocked_folds(card.pattern_group)
    expect = expected_counts(kernel, b, int8, programs=1, folds=folds, groups=int(b > 1))
    check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")
    got = tc.unpack_rank_outputs(packed)
    bitwise = True
    for w, one in enumerate(singles):
        want = tc.unpack_rank_outputs(program(one)())
        n = want[2]
        check((int(got[2][w]), int(got[4][w])) == (n, want[4]),
              f"{tag}: window {w}: n_valid / n_iters differ from its own program's")
        ok, why = ranking_agreement(list(zip(got[0][w][:n].tolist(), got[1][w][:n].tolist())),
                                    list(zip(want[0][:n].tolist(), want[1][:n].tolist())),
                                    RUN_RTOL, int8)
        check(ok, f"{tag}: window {w}: {why}")
        bitwise = bitwise and all(
            x.tobytes() == y.tobytes()
            for x, y in ((got[0][w][:n], want[0][:n]), (got[1][w][:n], want[1][:n]),
                         (got[3][w], want[3]))
        )
    # Every window's bits are its own program's: each per-window sum
    # runs in its window's fixed order (ops/fold.py), whatever the
    # group's common pads.
    check(bitwise, f"{tag}: a window's top-k, scores or residuals are not bitwise its own "
                   "program's")
    bound_bytes, bound_ms = program_bound(spmv, card, int8)
    out = {
        "windows": b,
        "launches": counts,
        "bitwise_vs_window_programs": bitwise,
        "plain_step": plain_step_check(torch, card, cfg, kernel),
        "bound_bytes": bound_bytes,
        "bound_ms": round(bound_ms, 6),
        "bound_by": "bytes",
    }
    if not timed:
        return out, counts

    def timed_ms(dg):
        return spin_event_host_ms(torch, program(dg), 5, PROGRAM_SPIN_CYCLES, settle=True)

    turns = {"stacked": [], "windows": []}
    for which in ("windows", "stacked", "stacked", "windows"):
        if which == "stacked":
            turns[which].append(timed_ms(card))
        else:
            each = [timed_ms(one) for one in singles]
            turns[which].append((sum(e for e, _ in each), sum(h for _, h in each)))
    for which, vals in turns.items():
        ev = _mean([v[0] for v in vals])
        host = _mean([v[1] for v in vals])
        out[which] = {
            "event_ms": round(ev, 4), "host_issue_ms": round(host, 4),
            "event_ms_per_window": round(ev / b, 4),
            "host_issue_ms_per_window": round(host / b, 4),
            "turns": [[round(e, 4), round(h, 4)] for e, h in vals],
        }
    return out, counts


def phase_batched(torch, spmv, pattern, replay, windows, graphs):
    """K18, the stacked rank program, on the card: groups of B = 1, 2, 4
    and 6 of the replay's config-5 kind windows (each window's graph as
    ``prepare_rank`` builds it, stacked by ``parallel.stack_window_graphs``),
    the same windows with ``kind_precision="int8"`` and ``"bf16"`` at B =
    2, 4 and 6, and groups of the config-5 window stacked twice for
    ``pallas`` (collapse off), ``packed_bf16`` (auto, collapse off),
    ``packed_blocked`` (auto at 64 MiB) and ``pcsr`` (auto at 16 MiB).
    Each group: its window-axis kernels bitwise their plain versions over
    50 launches (``stacked_kernel_checks``; not bf16, whose kernels are
    the f32 groups' but for the pair's rounding, held in the pattern
    phase), its program held to the windows' own (``stacked_program``)
    and K5's group kernel at its shapes over chains of 50 launches
    (``group_step_check``); the kind groups of 2, 4 and 6 and the int8
    group of 6 a step split by kernel (``step_split``); the kind groups
    and the int8 group of 6 timed against the per-window programs in
    turns."""
    import numpy as np

    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        divide_block_budget,
        host_subset,
    )

    from microrank_tpu_torch.ingest import admit_table

    t0 = time.perf_counter()
    tl, normal_table, table, _ = replay
    cfg = replay_config(tl)
    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(normal_table)
    table, _ = admit_table(table, cfg.ingest, source="table")  # as run() does first
    dev = torch.device("cuda")

    def us(iso):
        return int(np.datetime64(iso, "us").astype(np.int64))

    host = []
    for r in (r for r in windows if r.ranking):
        mask, nrm, abn, _, row_range = rca._detect_window(table, us(r.start), us(r.end))
        graph, _, kernel = rca.prepare_rank(table, mask, nrm, abn, row_range)
        check(kernel == "kind", f"batched: window {r.start} resolved to {kernel}")
        host.append(host_subset(graph, "kind"))

    def staged(g, kernel, device=dev):
        return device_subset(graph_from_numpy(g, device), kernel)

    singles = [staged(g, "kind") for g in host]
    launches, out = {}, {"phase": "batched", "kind": {}}
    for b in BATCH_SIZES:
        if b > len(host):
            continue
        stack = stack_window_graphs(host[:b])
        card = staged(stack, "kind")
        tag = f"batched/kind/{b}"
        info, counts = stacked_program(torch, spmv, pattern, tag, card, singles[:b], "kind", cfg)
        info["k6_bitwise_vs_plain_and_first_design"] = k6_bitwise(torch, tag, card, cfg, "kind")
        launches[tag] = counts
        if b > 1:
            info["group_step"] = group_step_check(torch, f"{tag}/group_step", card)
            info["step_split"] = step_split(torch, spmv, pattern, card, "kind")
        if b == max(x for x in BATCH_SIZES if x <= len(host)):
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card,
                                              staged(stack, "kind", "cpu")))
            # K6 over the group: one launch of each kernel for its windows.
            info["k6"] = measure_k6(torch, f"{tag}/k6", card, cfg, "kind", K6_REPS)
        info["trace_pads"] = [int(card.normal.kind.shape[-1]), int(card.abnormal.kind.shape[-1])]
        out["kind"][str(b)] = info
        del card
    # kind_precision="int8": one quantize_amax launch a group, the pair
    # and K5 with [B, 4] scales, each window's own; and "bf16".
    for precision in ("int8", "bf16"):
        pcfg = replay_config(tl, precision)
        out[f"kind_{precision}"] = {}
        for b in (2, 4, 6):
            if b > len(host):
                continue
            stack = stack_window_graphs(host[:b])
            card = staged(stack, "kind")
            tag = f"batched/kind_{precision}/{b}"
            info, counts = stacked_program(torch, spmv, pattern, tag, card, singles[:b], "kind",
                                           pcfg, timed=b == 6 and precision == "int8")
            info["k6_bitwise_vs_plain_and_first_design"] = k6_bitwise(torch, tag, card, pcfg,
                                                                      "kind")
            launches[tag] = counts
            int8 = precision == "int8"
            info["group_step"] = group_step_check(torch, f"{tag}/group_step", card,
                                                  card.pattern_group if int8 else None)
            if int8:
                info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card,
                                                  staged(stack, "kind", "cpu"),
                                                  precision="int8"))
                if b == 6:
                    info["step_split"] = step_split(torch, spmv, pattern, card, "kind",
                                                    int8=True)
            out[f"kind_{precision}"][str(b)] = info
            del card
    # The config-5 window stacked twice on the routes past the dense
    # budget too. The plain versions: on the CPU (pallas, pcsr) or the
    # window's own launches (packed_bf16, packed_blocked: the pattern
    # phase holds those to the CPU).
    for kernel, key, plain_on_cpu in (("pallas", "pallas/off", True),
                                      ("packed_bf16", "auto/off", False),
                                      ("packed_blocked", "auto/packed_blocked", False),
                                      ("pcsr", "auto/pcsr", True)):
        one = host_subset(graphs[key], kernel)
        single = staged(one, kernel)
        t1 = time.perf_counter()
        stack = stack_window_graphs([one, one])
        stack_ms = (time.perf_counter() - t1) * 1e3
        gcfg = cfg.replace(pagerank=divide_block_budget(cfg.pagerank, kernel, 2))
        card = device_subset(graph_from_numpy(stack, dev), kernel,
                             gcfg.pagerank.packed_block_bytes)
        tag = f"batched/{kernel}/2"
        info, counts = stacked_program(torch, spmv, pattern, tag, card, [single, single],
                                       kernel, gcfg, timed=False)
        info["k6_bitwise_vs_plain_and_first_design"] = k6_bitwise(torch, tag, card, gcfg, kernel)
        launches[tag] = counts
        info["group_step"] = group_step_check(torch, f"{tag}/group_step", card)
        if plain_on_cpu:
            host_card = device_subset(graph_from_numpy(stack, "cpu"), kernel,
                                      gcfg.pagerank.packed_block_bytes)
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, host_card))
        else:
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, None,
                                              [single, single]))
        info["stack_host_ms"] = round(stack_ms, 3)
        out[kernel] = info
        del card, single
        torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    return launches, out


# The quarantine phase's poison: shares of the replay's rows given a
# negative duration and an end before their start, and the spans moved
# into one trace past the per-trace cap (IngestConfig.max_spans_per_trace
# is 4096).
POISON_NEGATIVE = 0.01
POISON_INVERTED = 0.001
POISON_TRACE_SPANS = 5000


def poisoned_copy(table, seed=16):
    """A copy of a span table as a collector that garbles spans emits
    it: POISON_NEGATIVE of its rows with a negative duration,
    POISON_INVERTED with an end before the start, and POISON_TRACE_SPANS
    rows moved into the first row's trace, which grows past the cap.
    Seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = table.n_spans
    dur, end = table.duration_us.copy(), table.end_us.copy()
    trace = table.trace_id.copy()
    neg = rng.choice(n, int(n * POISON_NEGATIVE), replace=False)
    dur[neg] = -rng.integers(1, 10**6, neg.size)
    inv = rng.choice(n, int(n * POISON_INVERTED), replace=False)
    end[inv] = table.start_us[inv] - 1_000_000
    grow = rng.choice(n, POISON_TRACE_SPANS, replace=False)
    trace[grow] = trace[0]
    return table._replace(duration_us=dur, end_us=end, trace_id=trace)


def phase_quarantine(torch, spmv, pattern, tl, normal_table, table, workdir):
    """The dead-letter store on the card's main path: the replay's
    timeline poisoned (``poisoned_copy``) through ``TableRCA.run`` with
    ``out_dir``: ``quarantine.jsonl``'s records per reason equal
    ``admit_table``'s counts, every record parses and names a reason of
    ``REASONS``, nothing dropped under the default 16 MiB cap, and the
    run's launches those of its ranked windows; again at a 1 MiB cap:
    records + dropped = the rejected rows. Then ``admit_table`` timed
    with the file store and with the counting-only store in turns (file,
    counting, counting, file), and the file's bytes."""
    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.ingest import (
        QUARANTINE_NAME,
        REASONS,
        QuarantineStore,
        admit_table,
    )
    from microrank_tpu_torch.ingest import quarantine as store_module
    from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
    from microrank_tpu_torch.pipeline import TableRCA

    t0 = time.perf_counter()
    bad = poisoned_copy(table)
    poison_ms = (time.perf_counter() - t0) * 1e3
    _, counts = admit_table(bad, IngestConfig(), quarantine=QuarantineStore(None))
    rejected = sum(counts.values())
    check(set(counts) == {"bad_duration", "bad_timestamp", "trace_too_long"},
          f"quarantine: admission rejected {counts}")
    cfg = replay_config(tl)
    out = {"phase": "quarantine", "rows": bad.n_spans, "rejected_by_reason": counts,
           "poison_ms": round(poison_ms, 3)}
    for cap in (16 << 20, 1 << 20):
        tag = f"quarantine/{cap >> 20}MiB"
        run_dir = workdir / f"quarantine_{cap >> 20}"
        registry = MetricsRegistry()
        old = get_registry()
        set_registry(registry)
        rca = TableRCA(cfg.replace(ingest=IngestConfig(quarantine_max_bytes=cap)), device="cuda")
        rca.fit_baseline(normal_table)
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        results = rca.run(bad, out_dir=run_dir)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(spmv, pattern)
        set_registry(old)
        ranked = [r for r in results if r.ranking]
        kernels = {r.kernel for r in ranked}
        check(ranked and len(kernels) == 1, f"{tag}: ranked windows {len(ranked)}, {kernels}")
        expect = expected_counts(kernels.pop(), len(ranked))
        check(launches == expect, f"{tag}: launch counts {launches}, want {expect}")
        path = run_dir / QUARANTINE_NAME
        by_reason = {}
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            check(rec["reason"] in REASONS and rec["source"] == "table",
                  f"{tag}: a record names {rec['reason']!r} from {rec['source']!r}")
            by_reason[rec["reason"]] = by_reason.get(rec["reason"], 0) + 1
        store = store_module.get_quarantine()
        metric = registry.get("microrank_ingest_quarantine_dropped_total")  # None: never dropped
        dropped = 0 if metric is None else sum(s["value"] for s in metric.samples())
        check(store.dropped == dropped, f"{tag}: store dropped {store.dropped}, metric {dropped}")
        if cap == 16 << 20:
            check(by_reason == counts, f"{tag}: records {by_reason}, admission {counts}")
            check(dropped == 0, f"{tag}: {dropped} records dropped under the cap")
        else:
            check(sum(by_reason.values()) + dropped == rejected and dropped > 0,
                  f"{tag}: {sum(by_reason.values())} records + {dropped} dropped, "
                  f"{rejected} rejected")
        check(path.stat().st_size <= cap, f"{tag}: the file outgrew its cap")
        out[tag.split("/")[1]] = {
            "records_by_reason": by_reason, "dropped": int(dropped),
            "file_bytes": path.stat().st_size, "ranked": len(ranked), "run_ms": round(run_ms, 3),
            "launches": launches,
        }
    # admit_table with the file store against the counting-only one.
    turns = []
    for mode in ("file", "counting", "counting", "file"):
        path = workdir / "quarantine_turn" / QUARANTINE_NAME
        path.unlink(missing_ok=True)
        store = QuarantineStore(path if mode == "file" else None)
        t0 = time.perf_counter()
        admit_table(bad, IngestConfig(), quarantine=store)
        turns.append({"store": mode, "admit_ms": round((time.perf_counter() - t0) * 1e3, 3)})
    out["admit_turns"] = turns
    out["admit_ms_median"] = {m: _median([t["admit_ms"] for t in turns if t["store"] == m])
                              for m in ("file", "counting")}
    return out


def phase_policy(torch, spmv, pattern, normal, abnormal, workdir, empty_policy_dir):
    """The tuned policy on the card: a ``policy.json`` in the JAX
    package's schema (written here: the card's machine has no JAX) that
    tunes the config-5 window's workload profile to ``method="ochiai"``,
    found through ``MICRORANK_POLICY_DIR``; ``run_rca_native`` must give
    bitwise the ranking of an explicit ``SpectrumConfig(method="ochiai")``
    run (no policy), and count one "applied" policy event."""
    import os

    from microrank_tpu_torch.config import IngestConfig, MicroRankConfig, SpectrumConfig
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.obs import MetricsRegistry, set_registry
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.scenarios import policy

    # The profile as the table lane computes it: the admitted normal
    # table's span count and op cardinality, dedup unknown ("low").
    table, _ = admit_table(load_span_table(normal), IngestConfig())
    vocab, _ = compute_slo_from_table(table)
    key = policy.profile_from_counts(table.n_spans, len(vocab)).key()
    pdir = workdir / "policy"
    pdir.mkdir()
    (pdir / policy.POLICY_NAME).write_text(json.dumps({
        "version": policy.POLICY_VERSION,
        "profile_schema": policy.PROFILE_SCHEMA,
        "matrix_seed": None,
        "profiles": {key: {"method": "ochiai", "kernel": "auto", "pad_policy": "pow2q"}},
    }))
    registry = MetricsRegistry()
    set_registry(registry)
    os.environ["MICRORANK_POLICY_DIR"] = str(pdir)
    try:
        reset_counts(spmv, pattern)
        tuned = run_rca_native(normal, abnormal, MicroRankConfig(), device="cuda")
        counts = read_counts(spmv, pattern)
        events = {(s_["labels"]["lane"], s_["labels"]["outcome"]): s_["value"]
                  for s_ in registry.get("microrank_policy_events_total").samples()}
    finally:
        os.environ["MICRORANK_POLICY_DIR"] = str(empty_policy_dir)
        set_registry(MetricsRegistry())
    explicit = run_rca_native(
        normal, abnormal, MicroRankConfig(spectrum=SpectrumConfig(method="ochiai")),
        device="cuda",
    )
    ranked = [r for r in tuned if r.ranking]
    check(ranked, "policy: no window was ranked")
    check(events == {("table", "applied"): 1.0},
          f"policy: policy events {events}, want one 'applied'")
    same = [(r.start, r.ranking, r.rank_iterations) for r in tuned] == [
        (r.start, r.ranking, r.rank_iterations) for r in explicit
    ]
    check(same, "policy: the tuned run is not bitwise the explicit ochiai run")
    check(counts == expected_counts(ranked[0].kernel, len(ranked)),
          f"policy: launch counts {counts}")
    return counts, {
        "phase": "policy",
        "profile": key,
        "policy": {"method": "ochiai", "kernel": "auto", "pad_policy": "pow2q"},
        "policy_events": {f"{k[0]}/{k[1]}": v for k, v in events.items()},
        "ranked": len(ranked),
        "kernel": ranked[0].kernel,
        "top5": ranked[0].ranking[:5],
        "ranking_bitwise_vs_explicit_ochiai": True,
    }


def phase_follow(torch, spmv, pattern, tl, normal_table, table, timeline_csv, workdir):
    """``run_follow`` on the card over the replay's timeline CSV grown in
    three appends (a collector's: the first part written, the injected
    ``sleep`` appending the next byte range of the timeline file, and a
    no-op once all is written), ``idle_exit=1``: the follower's rankings
    are bitwise those of a sync ``TableRCA.run`` over the whole file (the
    replay's table: the same bytes) up to its last horizon. Polls,
    windows per poll and ms per poll (each poll re-parses the whole file,
    as the JAX package's follower does)."""
    import filecmp

    from microrank_tpu_torch.obs import MetricsRegistry, set_registry
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.pipeline.follow import run_follow

    t_phase = time.perf_counter()
    source, offsets = timeline_csv
    n = len(tl.windows)
    # Three parts: one window, one more, the rest. Each poll re-parses the
    # whole file, so small first parts keep the phase's parse time down
    # (1 + 2 + 8 windows parsed at bench.py's 8).
    cuts = [1, min(2, n), n] if n >= 3 else [n]
    ends = [offsets[c - 1] for c in cuts]
    csv = workdir / "follow" / "stream.csv"
    csv.parent.mkdir()
    written = [0]

    def grow(end):
        with open(source, "rb") as src, open(csv, "ab") as dst:
            src.seek(written[0])
            left = end - written[0]
            while left:
                chunk = src.read(min(left, 64 << 20))
                dst.write(chunk)
                left -= len(chunk)
        written[0] = end

    grow(ends[0])
    pending = list(ends[1:])
    marks, append_ms = [0.0], []

    def sleep(_):  # the collector appends the next part between polls
        t0 = time.perf_counter()
        if pending:
            grow(pending.pop(0))
        append_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        marks.append(time.perf_counter())

    per_poll = []

    def on_results(batch):
        per_poll.append((time.perf_counter() - marks[-1], sum(1 for r in batch if r.ranking)))

    registry = MetricsRegistry()
    set_registry(registry)
    rca = TableRCA(replay_config(tl), device="cuda")
    rca.fit_baseline(normal_table)
    reset_counts(spmv, pattern)
    out = workdir / "follow" / "out"
    marks[0] = time.perf_counter()
    ranked = run_follow(rca, csv, out, poll_seconds=0.0, idle_exit=1,
                        on_results=on_results, sleep=sleep)
    counts = read_counts(spmv, pattern)
    polls = registry.get("microrank_follow_polls_total").value()
    set_registry(MetricsRegistry())
    check(filecmp.cmp(csv, source, shallow=False),
          "follow: the grown file is not the timeline file")
    followed = [json.loads(ln) for ln in (out / "windows.jsonl").read_text().splitlines()]

    sync = TableRCA(replay_config(tl, pipeline_depth=1, async_dispatch=False), device="cuda")
    sync.fit_baseline(normal_table)
    ref = sync.run(table, end_us=int(table.start_us.max()), complete_only=True)
    got = [(r["start"], r["ranking"]) for r in followed if r["ranking"]]
    want = [(r.start, [list(x) for x in r.ranking]) for r in ref if r.ranking]
    check(ranked == len(want) and got == want,
          "follow: the followed rankings are not bitwise the sync run's over the file")
    check(not pending and len(per_poll) == len(cuts),
          f"follow: {len(per_poll)} productive polls for {len(cuts)} appends")
    check(counts == expected_counts("kind", ranked), f"follow: launch counts {counts}")
    return counts, {
        "phase": "follow",
        "windows": n,
        "appends_windows": [cuts[0]] + [b - a for a, b in zip(cuts, cuts[1:])],
        "polls": polls,
        "windows_ranked": ranked,
        "windows_per_poll": [w for _, w in per_poll],
        "ms_per_poll": [round(t * 1e3, 3) for t, _ in per_poll],
        "append_ms": append_ms,
        "rankings_bitwise_vs_sync_run": True,
        "phase_s": round(time.perf_counter() - t_phase, 3),
    }


def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_bound(n_rows, entries, n_x):
    """(bytes, bytes ms, operations ms) of one SpMV: indptr, the live
    entries' cols and vals, and x read once, y written once; 2 flops per
    entry."""
    nbytes = 4 * (n_rows + 1) + 8 * entries + 4 * n_x + 4 * n_rows
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, 2 * entries / F32_FLOPS_PER_S * 1e3


def step_matrices(torch, graph, gen):
    """One power-iteration step's six matrices at a graph's shapes, as
    the main path stages them: (group, layouts, xs), with random x
    vectors in the group's slots (rv_n, sv_n, rv_a, sv_a)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, spmv_layouts

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(graph, dev), "pallas")
    layouts = [*spmv_layouts(dgraph.normal), *spmv_layouts(dgraph.abnormal)]
    v = dgraph.normal.cov_unique.shape[0]
    sizes = (dgraph.normal.kind.shape[0], v, dgraph.abnormal.kind.shape[0], v)
    xs = [torch.rand(n, generator=gen, device=dev) for n in sizes]
    return dgraph.spmv_group, layouts, xs


def first_design(torch, spmv, layouts, xs):
    """The first, warp-per-row kernel over the same matrices: one launch
    per matrix, outputs preallocated. Returns (launch-all fn, outputs)."""
    lib = spmv.load_library()
    ys = [torch.empty(lay.n_rows, device=x.device) for lay, x in zip(layouts, xs)]
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()

    def run():
        for lay, x, y in zip(layouts, xs, ys):
            rc = lib.mr_coo_spmv_rows(
                lay.indptr.data_ptr(), lay.cols.data_ptr(), lay.vals.data_ptr(),
                x.data_ptr(), y.data_ptr(), lay.n_rows, x.shape[0], dev, stream,
            )
            check(rc == 0, f"first-design launch failed: {lib.mr_cuda_error_string(rc)}")

    return run, ys


def csr_of(torch, lay, n_x):
    e_live = int(lay.indptr[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(
            lay.indptr, lay.cols[:e_live], lay.vals[:e_live],
            size=(lay.n_rows, n_x), check_invariants=True,
        )


def measure_group(torch, spmv, name, group, layouts, xs):
    """Check and time one group of matrices on the card. ``xs`` are the
    group's slots; matrix m reads ``xs[group.x_slots[m]]``."""
    mx = [xs[s] for s in group.x_slots]
    ys = spmv.coo_spmv_group(group, xs)
    torch.cuda.synchronize()
    cpu_group = spmv.SpmvGroup(*(t.cpu() if torch.is_tensor(t) else t for t in group))
    ref = spmv.coo_spmv_group_plain(cpu_group, [x.cpu() for x in xs])
    bitwise = all(torch.equal(y.cpu(), r) for y, r in zip(ys, ref))
    check(bitwise, f"{name}: K1 differs from its plain version on the CPU")
    first = torch.cat(ys)
    again = [torch.cat(spmv.coo_spmv_group(group, xs)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, first) for a in again)
    check(repeatable, f"{name}: K1 is not bitwise repeatable over {REPEATS} launches")
    check(not bool(group.counters.any()), f"{name}: arrival counters left non-zero")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y_plain = torch.cat(spmv.coo_spmv_group_plain(group, xs))
    finally:
        torch.use_deterministic_algorithms(prev)
    diff = (first - y_plain).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")

    old, old_ys = first_design(torch, spmv, layouts, mx)
    old()
    old_rel = float(((torch.cat(old_ys) - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())
    check(old_rel <= KERNEL_RTOL, f"{name}: first design rel err {old_rel} > {KERNEL_RTOL}")
    csrs = [csr_of(torch, lay, int(x.shape[0])) for lay, x in zip(layouts, mx)]
    lib_out = torch.cat([torch.mv(c, x) for c, x in zip(csrs, mx)])
    lib_rel = float(((lib_out - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())

    # CUDA events per call behind a device spin; the two designs in
    # turns: first, chunked, chunked, first.
    calls = {
        "kernel": lambda: spmv.coo_spmv_group(group, xs),
        "first_design": old,
        "plain": lambda: spmv.coo_spmv_group_plain(group, xs),
        "library": lambda: [torch.mv(c, x) for c, x in zip(csrs, mx)],
    }
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("first_design", "kernel", "kernel", "first_design")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in ("kernel", "first_design")}
    ms["library"] = spin_event_ms(torch, calls["library"], 20)
    ms["plain"] = spin_event_ms(torch, calls["plain"], 3)
    total_bytes, bytes_ms, ops_ms = 0, 0.0, 0.0
    for lay, x in zip(layouts, mx):
        b, b_ms, o_ms = spmv_bound(lay.n_rows, int(lay.indptr[-1]), int(x.shape[0]))
        total_bytes, bytes_ms, ops_ms = total_bytes + b, bytes_ms + b_ms, ops_ms + o_ms
    return {
        "name": name,
        "matrices": len(layouts),
        "n_rows": [lay.n_rows for lay in layouts],
        "entries": [int(lay.indptr[-1]) for lay in layouts],
        "max_row_len": [int((lay.indptr[1:] - lay.indptr[:-1]).max()) for lay in layouts],
        "work_items": int(group.items.shape[0]),
        "max_chunks": group.max_chunks,
        "ms": round(ms["kernel"], 6),
        "first_design_ms": round(ms["first_design"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": total_bytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "first_design_max_rel_err": old_rel, "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": bitwise,
        "bitwise_repeatable_launches": REPEATS,
    }


def call_graph_terms(torch, graph, kernel, gen):
    """K1's call on the kind and packed paths at a graph's shapes, as
    the main path stages it: both partitions' call-graph terms (K3 for
    kind, K4's B_ss for packed) in one group, with random x vectors.
    Returns (group, layouts, xs)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset, ss_layout

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(host_subset(graph, kernel), dev), kernel)
    parts = (dgraph.normal, dgraph.abnormal)
    xs = [torch.rand(g.cov_unique.shape[0], generator=gen, device=dev) for g in parts]
    return dgraph.spmv_group, [ss_layout(g, kernel) for g in parts], xs


def lowered_budgets(graph):
    """Dense budgets that send the uncollapsed window past the default
    policy: 64 MiB keeps config 5's bitmaps (about 5.3 MB, within a
    quarter) but not its unpacked matrices (about 169 MB), so auto picks
    packed_blocked; 16 MiB puts the bitmaps past a quarter, so it picks
    pcsr. At other sizes (--spans, --ops) the same inequalities set the
    budgets from the window's shapes."""
    shapes = budget_inequalities(graph, 0)
    bits, unpacked = shapes["bitmap_bytes"], shapes["unpacked_bytes"]
    blocked, pcsr = 64 << 20, 16 << 20
    if not 4 * bits <= blocked < unpacked:
        blocked = 4 * bits
    if not 4 * bits > pcsr:
        pcsr = 2 * bits
    return {"packed_blocked": blocked, "pcsr": pcsr}


def spin_event_ms(torch, fn, reps, cycles=None):
    """Device time (ms) of one call of ``fn`` by CUDA events, each call
    queued behind a device-side spin of ``cycles`` (SPIN_CYCLES, ~2 ms)
    so that the host's issue time never shows between the events: the
    median over ``reps`` calls. ``fn`` must not wait on the device."""
    return spin_event_host_ms(torch, fn, reps, cycles)[0]


def spin_event_host_ms(torch, fn, reps, cycles=None, settle=False):
    """``spin_event_ms`` and, beside it, the host's time to issue one
    call (the host clock around ``fn`` while the device spins, so no
    wait on the device is in it): (event ms, host ms), medians over
    ``reps`` calls. ``settle``: drain the device after each call, so that
    calls of many launches never fill the launch queue (the host would
    then wait in ``fn`` for the device)."""
    fn()
    torch.cuda.synchronize()
    pairs, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles or SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        pairs.append((start, stop))
        if settle:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return _median([a.elapsed_time(b) for a, b in pairs]), _median(host)


def timer_check(torch):
    """The two device timers on work of known size: a device-to-device
    copy of 1 GiB (2 GiB moved), timed in turns by torch.profiler (device
    time per call) and by CUDA events behind a spin, each with the
    bandwidth it implies (a time that implies more than the card's
    3.35 TB/s is the timer's error); then the events' floor."""
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)

    def copy():
        dst.copy_(src)

    out = []
    for k in ("profiler", "events", "events", "profiler"):
        t = device_ms(torch, copy, 5) if k == "profiler" else spin_event_ms(torch, copy, 5)
        moved = 2 * src.numel() * 4
        out.append({"timer": k, "ms": t,
                    "tb_per_s": None if t is None else round(moved / t / 1e9, 3)})
    del src, dst
    torch.cuda.empty_cache()
    # The events' floor: a one-float add, the least a timed call can read.
    one = torch.zeros(1, device="cuda")
    out.append({"timer": "events", "call": "one-float add",
                "ms": spin_event_ms(torch, lambda: one.add_(1.0), 20)})
    return out


def measure_pcsr(torch, spmv, name, dgraph, reps, pallas_group=None):
    """Check and time the pcsr kernel's step at a window's shapes
    (``dgraph`` staged for pcsr on the card): bitwise its plain version on
    the CPU, the earlier design (K1 over ``pcsr_layouts``' work list) and,
    where given, the pallas work list of the same window; bitwise over
    REPEATS launches; within KERNEL_RTOL of its plain version on the
    card. Then timed in turns (earlier design, kernel, six cuSPARSE CSR
    matvecs, the same again in reverse) by CUDA events per call behind a
    device-side spin (the kernel's own time), by CUDA events over
    ``reps`` back-to-back calls and by torch.profiler (all device time
    per call); and the step's two halves as launches of their own. The
    bound counts the slabs' live entries, not their padding."""
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        STEP_X_SLOTS,
        pcsr_layouts,
        window_spmv_group,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    group = dgraph.spmv_group
    parts = (dgraph.normal, dgraph.abnormal)
    xs = [torch.rand(n, generator=gen, device=dev)
          for p in parts for n in (p.kind.shape[0], p.cov_unique.shape[0])]
    layouts = [lay for p in parts for lay in pcsr_layouts(p)]
    prior = window_spmv_group(dgraph, pcsr_layouts)
    mx = [xs[s] for s in STEP_X_SLOTS]

    first = torch.cat(spmv.pcsr_spmv_group(group, xs))
    vs_prior = torch.equal(first, torch.cat(spmv.coo_spmv_group(prior, xs)))
    check(vs_prior, f"{name}: differs from K1 over the pcsr work list")
    if pallas_group is not None:
        check(torch.equal(first, torch.cat(spmv.coo_spmv_group(pallas_group, xs))),
              f"{name}: differs from the pallas work list")
    torch.cuda.synchronize()
    cpu = spmv.PcsrGroup(
        spmv.SpmvGroup(*(t.cpu() if torch.is_tensor(t) else t for t in group.rows)),
        tuple(spmv.EllPart(*(t.cpu() if torch.is_tensor(t) else t for t in e)) for e in group.ell),
        group.order,
    )
    ref = torch.cat(spmv.pcsr_spmv_group_plain(cpu, [x.cpu() for x in xs]))
    check(torch.equal(first.cpu(), ref), f"{name}: differs from its plain version on the CPU")
    again = [torch.cat(spmv.pcsr_spmv_group(group, xs)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, first) for a in again),
          f"{name}: not bitwise repeatable over {REPEATS} launches")
    check(not bool(group.rows.counters.any()), f"{name}: arrival counters left non-zero")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y_plain = torch.cat(spmv.pcsr_spmv_group_plain(group, xs))
    finally:
        torch.use_deterministic_algorithms(prev)
    diff = (first - y_plain).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max())
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")
    csrs = [csr_of(torch, lay, int(x.shape[0])) for lay, x in zip(layouts, mx)]
    lib_out = torch.cat([torch.mv(c, x) for c, x in zip(csrs, mx)])
    lib_rel = float(((lib_out - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())

    calls = {
        "kernel": lambda: spmv.pcsr_spmv_group(group, xs),
        "prior": lambda: spmv.coo_spmv_group(prior, xs),
        "library": lambda: [torch.mv(c, x) for c, x in zip(csrs, mx)],
        "plain": lambda: spmv.pcsr_spmv_group_plain(group, xs),
    }
    # The step's two halves as launches of their own: K1 over the same
    # work items alone, and the slabs alone (with the call edges as their
    # only items): what one launch saves or costs against two.
    ell_only = spmv.PcsrGroup(
        spmv.spmv_group([layouts[1], layouts[4]], (1, 3), (mx[1].shape[0], mx[4].shape[0])),
        group.ell, (0, 1, 2, 3),
    )
    calls["items_alone"] = lambda: spmv.coo_spmv_group(group.rows, xs)
    calls["slabs_alone"] = lambda: spmv.pcsr_spmv_group(ell_only, xs)
    turns = []
    for k in ("prior", "kernel", "library", "library", "kernel", "prior"):
        turns.append({
            "call": k,
            "profiler_ms": device_ms(torch, calls[k], 20),
            "event_ms": spin_event_ms(torch, calls[k], 20),
            "back_to_back_event_ms": _time_ms(torch, calls[k], reps),
        })
    split = {}
    for k in ("items_alone", "slabs_alone", "slabs_alone", "items_alone"):
        split[k] = split.get(k, 0.0) + spin_event_ms(torch, calls[k], 20) / 2
    plain_ms = spin_event_ms(torch, calls["plain"], 3)

    def mean(k, key):
        got = [t[key] for t in turns if t["call"] == k and t[key] is not None]
        return round(sum(got) / len(got), 6) if got else None

    times = {k: {key: mean(k, key) for key in ("profiler_ms", "event_ms", "back_to_back_event_ms")}
             for k in ("kernel", "prior", "library")}

    def bound(pairs, ell_parts):
        total, b_ms, o_ms = 0, 0.0, 0.0
        for lay, x in pairs:
            b, bm, om = spmv_bound(lay.n_rows, int(lay.indptr[-1]), int(x.shape[0]))
            total, b_ms, o_ms = total + b, b_ms + bm, o_ms + om
        for e in ell_parts:
            n_rows, live = e.ops.shape[0], int((e.vals != 0).sum())
            b = 8 * live + 4 * xs[e.slot].shape[0] + 4 * n_rows
            total += b
            b_ms += b / HBM_BYTES_PER_S * 1e3
            o_ms += 2 * live / F32_FLOPS_PER_S * 1e3
        return total, b_ms, o_ms

    row_pairs = [(layouts[m], mx[m]) for m in (0, 1, 3, 4)]
    n_bytes, b_ms, o_ms = bound(row_pairs, group.ell)
    p_bytes, pb_ms, po_ms = bound(list(zip(layouts, mx)), ())
    # The kernel's own time: CUDA events around each call behind a device
    # spin (stable to a fraction of a percent across turns); the
    # profiler's sum of the same calls is kept beside it.
    return {
        "name": name,
        "ell_shapes": [list(e.ops.shape) for e in group.ell],
        "work_items": int(group.rows.items.shape[0]),
        "prior_work_items": int(prior.items.shape[0]),
        "entries": [int(lay.indptr[-1]) for lay in layouts],
        "ms": times["kernel"]["event_ms"],
        "timed_by": "cuda_events",
        "times_ms": times,
        "turns": turns,
        "split_event_ms": {k: round(split[k], 6) for k in ("items_alone", "slabs_alone")},
        "prior_ms": times["prior"]["event_ms"],
        "library_ms": times["library"]["event_ms"],
        "plain_ms": round(plain_ms, 6),
        "bound_ms": round(max(b_ms, o_ms), 6),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": n_bytes,
        "prior_bound_ms": round(max(pb_ms, po_ms), 6),
        "prior_bytes": p_bytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": True,
        "bitwise_vs_prior_work_list": vs_prior,
        "bitwise_vs_pallas_work_list": pallas_group is not None,
        "bitwise_repeatable_launches": REPEATS,
    }


def phase_kernel(torch, spmv, graphs, reps):
    """K1 per matrix (groups of one) at the uncollapsed shapes, then per
    step: the pallas path's grouped launch at both shapes ("off",
    "auto"), the auto path's launch of the two call-graph terms
    ("auto_path/kind", "auto_path/packed_bf16"), and the pcsr kernel's
    step at the window past the lowered budget ("pcsr", ``measure_pcsr``,
    against the pallas work list of the same window too)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    names = [f"{part}/{m}" for part in ("normal", "abnormal") for m in ("p_sr", "p_ss", "p_rs")]
    group, layouts, xs = step_matrices(torch, graphs["pallas/off"], gen)
    per_matrix = []
    for name, lay, slot, n_x in zip(names, layouts, group.x_slots, group.n_x):
        single = spmv.spmv_group([lay], (0,), (n_x,))
        per_matrix.append(measure_group(torch, spmv, name, single, [lay], [xs[slot]]))
    per_step = {"off": measure_group(torch, spmv, "step/off", group, layouts, xs)}
    pc_graph = device_subset(
        graph_from_numpy(host_subset(graphs["auto/pcsr"], "pcsr"), torch.device("cuda")), "pcsr"
    )
    per_step["pcsr"] = measure_pcsr(torch, spmv, "step/pcsr", pc_graph, reps, group)
    group, layouts, xs = step_matrices(torch, graphs["pallas/auto"], gen)
    per_step["auto"] = measure_group(torch, spmv, "step/auto", group, layouts, xs)
    for kernel, run in (("kind", "auto/auto"), ("packed_bf16", "auto/off")):
        name = f"auto_path/{kernel}"
        group, layouts, xs = call_graph_terms(torch, graphs[run], kernel, gen)
        per_step[name] = measure_group(torch, spmv, name, group, layouts, xs)
    return per_matrix, per_step


def pattern_inputs(torch, graph, kernel, gen):
    """The pattern-pair group of a graph as the main path stages it
    (both partitions), with random rv / sv vectors."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(host_subset(graph, kernel), dev), kernel)
    group = dgraph.pattern_group
    rvs = [torch.rand(p.n_cols, generator=gen, device=dev) for p in group.parts]
    svs = [torch.rand(p.pattern.shape[0], generator=gen, device=dev) for p in group.parts]
    return group, rvs, svs


def on_cpu(torch, pattern, group):
    """The same group rebuilt on the CPU (with the plain version's dense
    matrices)."""
    return pattern.pattern_group(
        [p.pattern.cpu() for p in group.parts], [p.w_len.cpu() for p in group.parts],
        [p.w_cov.cpu() for p in group.parts],
        [None if p.w_out is None else p.w_out.cpu() for p in group.parts],
        [p.n_cols for p in group.parts], blocked=group.blocked,
    )


def with_equal_rows_and_columns(torch, pattern, group):
    """A copy of the group whose patterns have row V/2 equal to row 0
    and the last column equal to column 1. Returns (group, pairs of
    (row, row) and (col, col) that must give equal bits)."""
    import numpy as np

    pats, pairs = [], []
    for p in group.parts:
        m = pattern.unpack_bits(p.pattern, p.n_cols).cpu().numpy().astype(np.uint8)
        v, k = m.shape
        m[v // 2] = m[0]
        m[:, k - 1] = m[:, 1]
        pats.append(torch.from_numpy(np.packbits(m, axis=1)).to(p.pattern.device))
        pairs.append(((0, v // 2), (1, k - 1)))
    eq = pattern.pattern_group(
        pats, [p.w_len for p in group.parts], [p.w_cov for p in group.parts],
        [p.w_out for p in group.parts], [p.n_cols for p in group.parts],
        blocked=group.blocked,
    )
    return eq, pairs


def pattern_bound(group, nnz):
    """(bytes, bytes ms, operations ms) of one pair call: each pattern
    read once as the bitmap [V, ceil(K/8)] the kernel reads (the kind
    build's bitmap as it is), rv, w_len, sv, w_cov (and w_out) read once,
    y_fwd, y_bwd (and x_ss) written once; one add per set cell and
    direction, plus the operand products. (int8's scales add 16 bytes,
    counted in; their maxima re-read the four operands, which the bound
    counts once.)"""
    nbytes, ops = 0, 0
    for p, n in zip(group.parts, nnz):
        v, k = p.pattern.shape[-2], p.n_cols
        ss = 0 if p.w_out is None else v  # w_out read, x_ss written
        nbytes += v * -(-k // 8) + 4 * (2 * k + 2 * v + ss) + 4 * (v + k + ss)
        ops += 2 * n + k + v + ss
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3


def measure_pattern(torch, pattern, name, group, rvs, svs, precision, cpu_check=True):
    """Check and time one step of the pattern pair (both partitions) on
    the card: one launch, or for int8 the scale launch and then the pair.
    ``cpu_check``: also hold it bitwise to its plain version computed on
    the CPU and check equal rows and columns of a constructed pattern
    (skipped at the giant shapes, where the card-side plain version and
    the repeat checks stand)."""
    int8 = precision == "int8"

    def step(g=group):
        scales = pattern.quantize_scales(g, rvs, svs) if int8 else None
        return pattern.pattern_pair_group(g, rvs, svs, precision, scales), scales

    def flat(outs, scales):
        parts = [t for pair in outs for t in pair if t is not None]
        return torch.cat(parts + ([] if scales is None else [scales]))

    calls0 = pattern.pattern_pair_group.launches
    outs, scales = step()
    torch.cuda.synchronize()
    first = flat(outs, scales)
    bitwise = None
    if cpu_check:
        cpu_group = on_cpu(torch, pattern, group)
        c_rvs, c_svs = [r.cpu() for r in rvs], [s_.cpu() for s_ in svs]
        c_scales = pattern.quantize_scales_plain(cpu_group, c_rvs, c_svs) if int8 else None
        ref = pattern.pattern_pair_plain(cpu_group, c_rvs, c_svs, precision, c_scales)
        bitwise = torch.equal(first.cpu(), flat(ref, c_scales))
        check(bitwise, f"{name}: the pattern pair differs from its plain version on the CPU")
        if group.blocked:  # K8's fwd partials as its plain layout has them
            for p, want in zip(group.parts, pattern.blocked_partials_plain(cpu_group, c_rvs)):
                check(want is None
                      or torch.equal(p.part[: want.numel()].view(want.shape).cpu(), want),
                      f"{name}: K8's fwd partials differ from blocked_partials_plain")
    again = [flat(*step()) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, first) for a in again),
          f"{name}: not bitwise repeatable over {REPEATS} launches")
    check(not any(bool(p.counters.any()) for p in group.parts),
          f"{name}: arrival counters left non-zero")
    check(not group.amax_scratch.any(), f"{name}: the scale launch left its scratch non-zero")
    if cpu_check:
        eq, pairs = with_equal_rows_and_columns(torch, pattern, group)
        eq_outs, _ = step(eq)
        torch.cuda.synchronize()
        for (y_fwd, y_bwd, _), ((r0, r1), (c0, c1)) in zip(eq_outs, pairs):
            check(bool(y_fwd[r0] == y_fwd[r1]) and bool(y_bwd[c0] == y_bwd[c1]),
                  f"{name}: equal rows or columns give different bits")

    def plain():
        s_ = pattern.quantize_scales_plain(group, rvs, svs) if int8 else None
        return pattern.pattern_pair_plain(group, rvs, svs, precision, s_), s_

    y_plain = flat(*plain())
    diff = (first - y_plain).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")
    card_bitwise = bool(torch.equal(first, y_plain))
    if int8:  # integer sums: the plain version on the card gives the same bits
        check(card_bitwise, f"{name}: the int8 step differs from its plain version on the card")

    # The library form JAX computes (a yardstick the port never calls):
    # f32 / bf16, the loop-invariant cast matrix and a pair of matmuls per
    # partition; int8, one torch._int_mm per direction and partition over
    # the unpacked int8 pattern (its transpose for the bwd direction, so
    # that the pattern is the left operand) with the quantized operand
    # padded to 8 columns, or four f32 torch.matmul where _int_mm refuses
    # the shape.
    mats, operands, nnz = [], [], []
    for i, (p, rv, sv) in enumerate(zip(group.parts, rvs, svs)):
        m = pattern.unpack_bits(p.pattern, p.n_cols)
        nnz.append(int(m.sum()))
        a, b = rv * p.w_len, sv * p.w_cov
        if int8:
            mats.append(m)
            operands.append((pattern.quantize_with(a, scales[2 * i]),
                             pattern.quantize_with(b, scales[2 * i + 1])))
        else:
            dtype = torch.bfloat16 if precision == "bf16" else torch.float32
            mats.append(m.to(dtype))
            operands.append((a.to(dtype), b.to(dtype)))
    library_form = "matmul"
    if int8:
        def pad8(q):  # the quantized vector as column 0 of 8
            out = torch.zeros((q.shape[0], 8), dtype=torch.int8, device=q.device)
            out[:, 0] = q.to(torch.int8)
            return out

        i8 = [(m.to(torch.int8), m.t().contiguous().to(torch.int8)) for m in mats]
        pad8 = [(pad8(a), pad8(b)) for a, b in operands]
        f32 = [(m, m.t().contiguous()) for m in mats]
        f32_ops = [(a.float(), b.float()) for a, b in operands]

        def int_mm():
            return [(torch._int_mm(mf, a8)[:, 0], torch._int_mm(mt, b8)[:, 0])
                    for (mf, mt), (a8, b8) in zip(i8, pad8)]

        try:
            lib_int = int_mm()
            torch.cuda.synchronize()
            library = int_mm
            library_form = "torch._int_mm"
            lib_out = torch.cat([torch.cat([f.float() * scales[2 * i], b.float() * scales[2 * i + 1]])
                                 for i, (f, b) in enumerate(lib_int)])
        except RuntimeError as exc:
            library_form = f"torch.matmul f32 (torch._int_mm refused: {str(exc)[:160]})"

            def library():
                return [(mf @ a, mt @ b) for (mf, mt), (a, b) in zip(f32, f32_ops)]

            lib_out = torch.cat([torch.cat([f * scales[2 * i], b * scales[2 * i + 1]])
                                 for i, (f, b) in enumerate(library())])
    else:
        def library():
            return [(m @ a, b @ m) for m, (a, b) in zip(mats, operands)]

        lib_out = torch.cat([torch.cat([f.float(), b.float()]) for f, b in library()])
    ours = torch.cat([torch.cat([f, b]) for f, b, _ in outs])
    lib_rel = float(((lib_out - ours).abs() / ours.abs().clamp_min(1e-30)).max())

    calls = {"kernel": lambda: step(), "plain": plain, "library": library}
    # CUDA events per call behind a device spin, in turns.
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("library", "kernel", "kernel", "library")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in ("kernel", "library")}
    ms["plain"] = spin_event_ms(torch, plain, 3)
    nbytes, bytes_ms, ops_ms = pattern_bound(group, nnz)
    if int8:
        nbytes += 4 * len(scales)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "name": name,
        "precision": precision,
        "n_rows": [p.pattern.shape[0] for p in group.parts],
        "n_cols": [p.n_cols for p in group.parts],
        "tiles": [[-(-p.pattern.shape[0] // pattern.TILE_R), -(-p.n_cols // pattern.TILE_C)]
                  for p in group.parts],
        "bitmap_bytes_read": [p.pattern.numel() for p in group.parts],
        "set_cells": nnz,
        "launches_during_checks": pattern.pattern_pair_group.launches - calls0,
        "ms": round(ms["kernel"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "library_form": library_form,
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": bitwise,
        "bitwise_vs_card_plain": card_bitwise,
        "bitwise_repeatable_launches": REPEATS,
        "equal_rows_and_columns_bitwise": True if cpu_check else None,
    }
    if group.blocked:
        out.update(previous_design(torch, pattern, group, rvs, svs, first, nbytes))
    if int8:
        # The two launches of the step apart: the scales alone, and the
        # pair alone on fixed scales.
        out["scale_ms"] = round(spin_event_ms(
            torch, lambda: pattern.quantize_scales(group, rvs, svs), 20), 6)
        out["pair_ms"] = round(spin_event_ms(
            torch, lambda: pattern.pattern_pair_group(group, rvs, svs, "int8", scales), 20), 6)
        out["scale_plain_ms"] = round(spin_event_ms(
            torch, lambda: pattern.quantize_scales_plain(group, rvs, svs), 3), 6)
        plain_scales = pattern.quantize_scales_plain(group, rvs, svs)
        out["scale_max_abs_err"] = float((scales - plain_scales).abs().max())
        # The scale launch alone: each operand and its weight read once,
        # the scales written once.
        scale_bytes = sum(4 * 2 * (p.n_cols + p.pattern.shape[0]) for p in group.parts)
        scale_bytes += 4 * len(scales)
        out["scale_bytes"] = scale_bytes
        out["scale_bound_ms"] = round(scale_bytes / HBM_BYTES_PER_S * 1e3, 6)
        out["scales"] = [float(x) for x in scales]
    return out


def tile_twin(pattern, group):
    """The tile kernel's group (K8's previous design) over the bitmaps and
    weights of K8's ``group``."""
    return pattern.pattern_group(
        [p.pattern for p in group.parts], [p.w_len for p in group.parts],
        [p.w_cov for p in group.parts], [p.w_out for p in group.parts],
        [p.n_cols for p in group.parts],
    )


def flat_pair(torch, outs):
    return torch.cat([t for pair in outs for t in pair if t is not None])


def previous_design(torch, pattern, group, rvs, svs, first, nbytes):
    """K8's kernel against the tile kernel in f32 on the same inputs:
    bitwise each other, timed in turns by CUDA events behind a spin; and
    the design's floor: the bound's ``nbytes`` plus K8's fwd partials
    written once and read once (4 bytes per row and column tile, for
    partitions of more than one column tile)."""
    twin = tile_twin(pattern, group)
    calls = {
        "blocked": lambda: pattern.pattern_pair_group(group, rvs, svs),
        "previous": lambda: pattern.pattern_pair_group(twin, rvs, svs),
    }
    check(torch.equal(flat_pair(torch, calls["previous"]()), first),
          "K8's kernel differs from the tile kernel (f32) on the same inputs")
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("previous", "blocked", "blocked", "previous")]
    n_cts = [-(-p.n_cols // pattern.TILE_C) for p in group.parts]
    traffic = sum(2 * 4 * p.pattern.shape[0] * n for p, n in zip(group.parts, n_cts) if n > 1)
    floor = nbytes + traffic
    out = {
        "previous_design_ms": round(_mean([t for k, t in turns if k == "previous"]), 6),
        "design_turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bitwise_vs_previous_design": True,
        "scratch_bytes": sum(4 * (p.part.numel() + p.counters.numel()) for p in group.parts),
        "previous_scratch_bytes": sum(4 * (p.part.numel() + p.counters.numel())
                                      for p in twin.parts),
        "scratch_traffic_bytes": traffic,
        "floor_bytes": floor,
        "floor_ms": round(floor / HBM_BYTES_PER_S * 1e3, 6),
    }
    del twin
    return out


def random_bitmap(torch, v, k, density, gen):
    """uint8[v, ceil(k / 8)], np.packbits order, each bit set with
    probability ``density`` (every bit at 1.0), made on the card from
    ``gen`` 256 rows at a time."""
    dev = gen.device
    n_bytes = -(-k // 8)
    if density >= 1.0:
        return torch.full((v, n_bytes), 255, dtype=torch.uint8, device=dev)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    out = torch.empty((v, n_bytes), dtype=torch.uint8, device=dev)
    for r0 in range(0, v, 256):
        n = min(256, v - r0)
        bits = torch.rand((n, n_bytes * 8), generator=gen, device=dev) < density
        byte = (bits.view(n, n_bytes, 8).to(torch.int32) * weights).sum(-1)
        out[r0: r0 + n] = byte.to(torch.uint8)
    return out


def blocked_density_sweep(torch, pattern, group, densities=(0.02, 0.5, 1.0), reps=5):
    """K8's kernel and the tile kernel at the shapes of ``group`` (the
    giant window's) over synthetic bitmaps of each density from a seeded
    torch.Generator: bitwise each other, each timed by CUDA events behind
    a spin. Ranks nothing."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(4)
    rvs = [torch.rand(p.n_cols, generator=gen, device="cuda") for p in group.parts]
    svs = [torch.rand(p.pattern.shape[0], generator=gen, device="cuda") for p in group.parts]
    out = []
    for density in densities:
        g = pattern.pattern_group(
            [random_bitmap(torch, p.pattern.shape[0], p.n_cols, density, gen)
             for p in group.parts],
            [p.w_len for p in group.parts], [p.w_cov for p in group.parts],
            [p.w_out for p in group.parts], [p.n_cols for p in group.parts], blocked=True,
        )
        twin = tile_twin(pattern, g)
        new = flat_pair(torch, pattern.pattern_pair_group(g, rvs, svs))
        check(torch.equal(new, flat_pair(torch, pattern.pattern_pair_group(twin, rvs, svs))),
              f"density {density}: K8's kernel differs from the tile kernel")
        out.append({
            "density": density,
            "ms": round(spin_event_ms(torch, lambda: pattern.pattern_pair_group(g, rvs, svs),
                                      reps), 6),
            "previous_design_ms": round(spin_event_ms(
                torch, lambda: pattern.pattern_pair_group(twin, rvs, svs), reps), 6),
            "bitwise_vs_previous_design": True,
        })
        del g, twin
    return out


def pattern_sweep(torch, pattern):
    """Where K4's time goes: one-partition bitmaps of 30% density at
    shapes that isolate the two folds — the full normal partition
    (3072 x 7168: 24 x 14 tiles); few rows (64 x 7168: one row stripe of
    14 tiles, the fwd fold alone); few columns (3072 x 256: one column
    stripe of 24 tiles, the bwd fold alone); one tile (64 x 256, no
    fold). Device ms per call."""
    import numpy as np

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(2)
    rng = np.random.default_rng(2)
    out = []
    for v, k in ((3072, 7168), (64, 7168), (3072, 256), (64, 256)):
        bits = torch.from_numpy(np.packbits(rng.random((v, k)) < 0.3, axis=1)).cuda()
        vec = lambda n: torch.rand(n, generator=gen, device="cuda")  # noqa: E731
        group = pattern.pattern_group([bits], [vec(k)], [vec(v)], [vec(v)], [k])
        rv, sv = vec(k), vec(v)
        ms = spin_event_ms(
            torch, lambda: pattern.pattern_pair_group(group, [rv], [sv], "bf16"), 20
        )
        out.append({"rows": v, "cols": k, "ms": round(ms, 6)})
    return out


def phase_pattern(torch, pattern, graphs):
    """K2 at the collapsed shapes (f32, bf16; int8 at the int8 run's
    window, the scale launch and the pair) and K4 at the uncollapsed ones
    (packed, packed_bf16), and K8's kernel there too (the packed_blocked
    run's window): one pair call per step for both partitions."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(1)
    out = {}
    group, rvs, svs = pattern_inputs(torch, graphs["auto/auto"], "kind", gen)
    for precision in ("f32", "bf16"):
        name = f"kind_{precision}"
        out[name] = measure_pattern(torch, pattern, name, group, rvs, svs, precision)
    group, rvs, svs = pattern_inputs(torch, graphs["auto/int8"], "kind", gen)
    out["kind_int8"] = measure_pattern(torch, pattern, "kind_int8", group, rvs, svs, "int8")
    group, rvs, svs = pattern_inputs(torch, graphs["auto/off"], "packed", gen)
    for precision in ("f32", "bf16"):
        name = "packed_bf16" if precision == "bf16" else "packed"
        out[name] = measure_pattern(torch, pattern, name, group, rvs, svs, precision)
    group, rvs, svs = pattern_inputs(torch, graphs["auto/packed_blocked"], "packed_blocked", gen)
    out["packed_blocked"] = measure_pattern(torch, pattern, "packed_blocked", group, rvs, svs,
                                            "f32")
    return out


def bits(torch, t):
    """A tensor's bits, for bitwise comparison (NaN included)."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def plain_step_check(torch, dgraph, cfg, kernel):
    """One window (its layouts staged) through the step kernel and
    through the plain step (``power_step_plain``) on the card (a stacked
    group through PR 13's group kernel too): the weights, carried
    vectors, score vectors, residual trace and n_iters of
    ``window_weights_full``, and the ranking of
    ``rank_window_traced_core``, must be bitwise equal. Returns what it
    compared."""
    import functools

    import numpy as np

    from microrank_tpu_torch.ops import step
    from microrank_tpu_torch.rank_backends import torch_cuda

    def run():
        weights = torch_cuda.window_weights_full(dgraph, cfg.pagerank, kernel)
        ranked = torch_cuda.fetch_rank_outputs(torch_cuda.rank_window_traced_core(
            dgraph, cfg.pagerank, cfg.spectrum, kernel))
        return weights, ranked

    got = run()
    wants = {}
    saved = torch_cuda.StepWindow
    stacked = dgraph.normal.kind.dim() == 2
    for mode in ("plain", "group_units") if stacked else ("plain",):
        torch_cuda.StepWindow = functools.partial(step.StepWindow, mode=mode)
        try:
            wants[mode] = run()
        finally:
            torch_cuda.StepWindow = saved
    torch.cuda.synchronize()
    names = ("n_weight", "a_weight", "rv_n", "rv_a", "residuals", "n_iters", "score_n",
             "score_a")
    for mode, want in wants.items():
        for name, a, b in zip(names, got[0], want[0]):
            check(torch.equal(bits(torch, a), bits(torch, b)),
                  f"{kernel}: {name} through the step kernel differs from the {mode} step's")
        for name, a, b in zip(("top_idx", "top_scores", "n_valid", "residuals", "n_iters"),
                              got[1], want[1]):
            check(np.asarray(a).tobytes() == np.asarray(b).tobytes(),
                  f"{kernel}: {name} of the ranking differs from the {mode} step's")
    check(not dgraph.step_scratch.any(), f"{kernel}: the step kernel left its scratch non-zero")
    residuals, n_iters = np.asarray(got[1][3]), np.asarray(got[1][4])
    final = [[float(x) for x in r[:, max(int(n) - 1, 0)]]
             for r, n in zip(residuals.reshape(-1, *residuals.shape[-2:]), n_iters.reshape(-1))]
    return {
        "bitwise_vs_plain_step": True,
        "bitwise_vs_group_units_step": True if stacked else None,
        "compared": list(names) + ["top_idx", "top_scores", "n_valid"],
        "n_iters": n_iters.tolist(),
        "final_residual": final if stacked else final[0],
        "any_nan": bool(torch.isnan(got[0][0]).any() or torch.isnan(got[0][1]).any()),
    }


def random_step_inputs(torch, gen, sizes, dev, empty=()):
    """Per partition (V, T) = sizes[p]: the step's products (y_sr,
    y_ss, y_rs), its carry (sv, rv) and pref, uniform in [0, 1); a
    partition in ``empty`` all zeros (empty at its pad)."""
    products, carry, prefs = [], [], []
    for p, (v, t) in enumerate(sizes):
        vecs = [torch.rand(n, generator=gen, device=dev) for n in (v, v, t, t, v, t)]
        if p in empty:
            vecs = [torch.zeros_like(x) for x in vecs]
        products.append(tuple(vecs[:3]))
        prefs.append(vecs[3])
        carry.append((vecs[4], vecs[5]))
    return tuple(products), tuple(carry), prefs


def step_chain(torch, fn, plan, products, carry, n_steps, want_scales=False, max_blocks=None):
    """``n_steps`` steps on fixed products from ``carry``: through one
    window of the fused kernel (``fn`` None, as the main path runs it;
    its grid capped at ``max_blocks``) or a chain of ``fn`` calls
    (power_step, power_step_plain): every carry
    and scale, the residuals, n_iters and the running flag, as the int32
    bits of one tensor."""
    from microrank_tpu_torch.ops import step

    dev = carry[0][0].device
    residuals = torch.zeros((2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if plan.tol is not None:
        n_iters = torch.zeros((), dtype=torch.int32, device=dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
    win = None
    if fn is None:
        win = step.StepWindow(plan, carry, residuals, n_iters, running, max_blocks=max_blocks)
    out = []
    for i in range(n_steps):
        scales_i = want_scales and i + 1 < n_steps
        if win is None:
            carry, scales = fn(plan, products, carry, residuals, i, n_iters, running, scales_i)
        else:
            carry, scales = win.step(products, i, scales_i)
        # A window's buffers are written again two steps on: clones.
        out += [t.clone() for part in carry for t in part]
        out += [] if scales is None else [scales.clone()]
    out = [torch.cat(out + [residuals.reshape(-1)]).view(torch.int32)]
    if n_iters is not None:
        out += [n_iters.reshape(1), running.to(torch.int32).reshape(1)]
    return torch.cat(out)


def step_bound(sizes):
    """(bytes, bytes ms) of one step of both partitions: y_sr, y_ss, sv
    (V floats each), y_rs, pref, rv (T each) read once, sv', rv' written
    once; the scalars and the residual column are noise."""
    nbytes = sum(16 * (v + t) for v, t in sizes)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def measure_step(torch, name, sizes, reps, scale_group=None):
    """Check and time one power-iteration step's tail (both partitions)
    at ``sizes`` ((V, T) per partition, the window's) on random
    products. Checks: one step of the fused kernel bitwise its plain
    version on the card; chains of 25 steps through one window (25
    launches) bitwise the plain chain, with the default configuration,
    with a tol (running, then frozen), with the first partition empty,
    and without normalization; with ``scale_group`` (the int8 window's
    pattern group) the fused int8 scales of every step too. Timed by
    CUDA events behind a spin, a window's step call as the main path
    makes it, in turns with the plain step (new, plain, plain, new)
    beside the byte bound; the host's time to issue a window's step
    call; the window's grid, elements a thread and register slots."""
    from microrank_tpu_torch.config import PageRankConfig
    from microrank_tpu_torch.ops import step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = PageRankConfig()
    products, carry, prefs = random_step_inputs(torch, gen, sizes, dev)

    def plan_of(prefs_, tol=None, normalize=True, group=None):
        return step.step_plan(prefs_, cfg.call_weight, cfg.damping, tol, normalize,
                              step.step_scratch(dev), group)

    plan = plan_of(prefs)
    flats = {}
    for label, fn in (("fused", step.power_step), ("plain", step.power_step_plain)):
        res = torch.zeros((2, STEPS), dtype=torch.float32, device=dev)
        new, _ = fn(plan, products, carry, res, 0)
        flats[label] = torch.cat([t for part in new for t in part] + [res.reshape(-1)])
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, flats["fused"]), bits(torch, flats["plain"])),
          f"{name}: the fused step kernel differs from the plain step")
    err = float((flats["fused"] - flats["plain"]).abs().max())
    # Chains of 25 steps on fixed products: every step after the first
    # gives the same vectors (residual 0), so a tol of half the first
    # residual runs one step and freezes the rest.
    tol = float(flats["plain"][-2 * STEPS:].view(2, STEPS)[:, 0].max()) / 2
    e_products, e_carry, e_prefs = random_step_inputs(torch, gen, sizes, dev, empty=(0,))
    chains = {
        "default": (plan, products, carry, False),
        "tol": (plan_of(prefs, tol), products, carry, False),
        "empty_partition": (plan_of(e_prefs, 1e-4), e_products, e_carry, False),
        "no_normalize": (plan_of(prefs, normalize=False), products, carry, False),
    }
    if scale_group is not None:
        chains["int8_scales"] = (plan_of(prefs, group=scale_group), products, carry, True)
    for label, (pl, pr, ca, scales) in chains.items():
        before = step.power_step.launches
        a = step_chain(torch, None, pl, pr, ca, STEPS, scales)
        check(step.power_step.launches - before == STEPS * STEP_LAUNCHES,
              f"{name}: {label}: not one fused launch a step")
        c = step_chain(torch, step.power_step_plain, pl, pr, ca, STEPS, scales)
        torch.cuda.synchronize()
        check(torch.equal(a, c), f"{name}: {label} chain of the fused kernel differs from plain")
        check(not pl.scratch.any(), f"{name}: {label}: the step kernel left its scratch non-zero")

    res = torch.zeros((2, STEPS), dtype=torch.float32, device=dev)
    wins = {mode: step.StepWindow(plan, carry, res, mode=mode) for mode in ("kernel", "plain")}
    calls = {
        "new": lambda: wins["kernel"].step(products, 0),
        "plain": lambda: wins["plain"].step(products, 0),
    }
    turns = ("new", "plain", "plain", "new")
    times, in_turns = {}, []
    for k in turns:
        t, host = spin_event_host_ms(torch, calls[k], reps)
        times.setdefault(k, []).append((t, host))
        in_turns.append([k, t, host])
    win = wins["kernel"]
    kcfg = step.kernel_config(dev)
    out = {
        "shapes": [list(x) for x in sizes], "max_abs_err": err, "bitwise_vs_plain": True,
        "chains_bitwise_vs_plain": sorted(chains),
        "launches_per_step": STEP_LAUNCHES,
        "grid": win.grid, "blocks_per_sm": kcfg.blocks_per_sm, "sms": kcfg.sms,
        "max_blocks": kcfg.max_blocks, "register_slots": win.slots,
        "elements_per_thread": win.per_thread,
        "in_registers": win.per_thread <= win.slots,
        "turns": in_turns,  # [call, event ms, host issue ms], in order
        "ms": min(t for t, _ in times["new"]),
        "plain_ms": min(t for t, _ in times["plain"]),
        "host_issue_ms": min(h for _, h in times["new"]),
        "plain_host_issue_ms": min(h for _, h in times["plain"]),
    }
    nbytes, bytes_ms = step_bound(sizes)
    out.update(bound_bytes=nbytes, bound_ms=bytes_ms, bound_by="bytes",
               # No single PyTorch call computes the step (a combination,
               # two maxima, two divisions, the residual maxima).
               library_ms=None, bound_share=round(bytes_ms / out["ms"], 4))
    return out


def window_sizes(dgraph):
    return [(int(p.cov_unique.shape[0]), int(p.kind.shape[0]))
            for p in (dgraph.normal, dgraph.abnormal)]


def rank_issue_split(torch, dgraph, cfg, kernel, reps=5, plain_k6=False):
    """The host's time to issue one rank program as the lane issues a
    window (``rank_window_traced_core``, then ``pack_rank_outputs``),
    each program queued behind a ~100 ms device spin so that no wait on
    the device is in it, split in three:

    * the set-up before the loop: K6's set-up (``rank_setup``: the
      preference and initial vectors), the step plan, K5's window
      (``k5_setup``) and int8's first scales (``quantize``);
    * the steps, by wrapper: the pattern pair, K1 and K9 (the products)
      and K5, and the loop's own Python between them (``loop_other``);
    * the epilogue: K6's epilogue (``rank_epilogue``: the finish of both
      partitions, the spectrum and the top-k), and the pack with its
      copy.

    Each wrapper is timed by the host clock around its call, by timers
    put in place of the names ``rank_backends.torch_cuda`` calls; ms,
    medians over ``reps`` programs, with the calls counted. The same
    program uninstrumented is timed in turns (``total_uninstrumented``):
    the difference is the timers' own cost. ``plain_k6``: the program
    calls K6's plain versions (``rank_setup_plain``,
    ``rank_epilogue_plain``, on the same card tensors) in place of the
    two kernels: a comparison here, not a switch of the program."""
    from microrank_tpu_torch.ops import epilogue, setup
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    events = []

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            events.append((name, t0, time.perf_counter()))
            return out
        return call

    names = {"pattern_pair_group": "pattern_pair", "coo_spmv_group": "k1",
             "pcsr_spmv_group": "k9", "quantize_scales": "quantize",
             "rank_setup": "k6_setup", "rank_epilogue": "k6_epilogue"}
    saved = {attr: getattr(tc, attr) for attr in [*names, "StepWindow"]}
    use = dict(saved)
    if plain_k6:
        use.update(rank_setup=setup.rank_setup_plain, rank_epilogue=epilogue.rank_epilogue_plain)

    def timed_window(*args, **kw):
        t0 = time.perf_counter()
        win = saved["StepWindow"](*args, **kw)
        events.append(("k5_setup", t0, time.perf_counter()))
        win.step = timed("k5", win.step)
        return win

    def program():
        events.clear()
        torch.cuda._sleep(PROGRAM_SPIN_CYCLES)
        t0 = time.perf_counter()
        outs = tc.rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)
        t1 = time.perf_counter()
        tc.pack_rank_outputs(outs)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        return t0, t1, t2, list(events)

    def instrument(on):
        for attr, label in names.items():
            setattr(tc, attr, timed(label, use[attr]) if on else use[attr])
        tc.StepWindow = timed_window if on else saved["StepWindow"]

    rows, plain = [], []
    try:
        for turn in range(2 * reps + 2):  # warm pair first; instrumented, then not
            instrument(turn % 2 == 0)
            t0, t1, t2, ev = program()
            if turn < 2:
                continue
            if turn % 2:
                plain.append((t2 - t0) * 1e3)
                continue
            loop_ev = [e for e in ev if e[0] in ("pattern_pair", "k1", "k9", "k5")]
            first = min(e[1] for e in loop_ev)
            last = max(e[2] for e in ev if e[0] == "k5")

            def dur(label, lo=-1e300, hi=1e300):
                return sum(b - a for n, a, b in ev if n == label and a >= lo and b <= hi) * 1e3

            row = {"total": (t2 - t0) * 1e3, "setup": (first - t0) * 1e3,
                   "setup_k6": dur("k6_setup"), "setup_k5_window": dur("k5_setup"),
                   "setup_quantize": dur("quantize", hi=first),
                   "loop": (last - first) * 1e3,
                   **{f"loop_{n}": dur(n, lo=first, hi=last)
                      for n in ("pattern_pair", "k1", "k9", "k5")},
                   "epilogue": (t2 - last) * 1e3, "epilogue_k6": dur("k6_epilogue"),
                   "epilogue_pack": (t2 - t1) * 1e3}
            row["setup_other"] = (row["setup"] - row["setup_k6"] - row["setup_k5_window"]
                                  - row["setup_quantize"])
            row["loop_other"] = row["loop"] - sum(row[f"loop_{n}"]
                                                  for n in ("pattern_pair", "k1", "k9", "k5"))
            row["epilogue_other"] = row["epilogue"] - row["epilogue_k6"] - row["epilogue_pack"]
            row["calls"] = {n: sum(1 for e in ev if e[0] == n)
                            for n in ("pattern_pair", "k1", "k9", "k5", "quantize", "k6_setup",
                                      "k6_epilogue")}
            rows.append(row)
    finally:
        for attr, fn in saved.items():
            setattr(tc, attr, fn)
    out = {k: round(_median([r[k] for r in rows]), 4) for k in rows[0] if k != "calls"}
    out["calls"] = rows[0]["calls"]
    out["total_uninstrumented"] = round(_median(plain), 4)
    out["reps"] = reps
    out["shares"] = {k: round(out[k] / out["total"], 4) for k in ("setup", "loop", "epilogue")}
    return out


def issue_split_turns(torch, dgraph, cfg, kernel):
    """``rank_issue_split`` with K6's kernels and with its plain versions
    in turns (kernels, plain, plain, kernels): each side's two splits,
    and the medians of their set-up and epilogue."""
    order = (False, True, True, False)
    splits = [rank_issue_split(torch, dgraph, cfg, kernel, plain_k6=p) for p in order]
    out = {"kernels": [x for x, p in zip(splits, order) if not p],
           "plain": [x for x, p in zip(splits, order) if p]}
    for side in ("kernels", "plain"):
        out[f"{side}_setup_epilogue_total"] = [
            [x["setup"], x["epilogue"], x["total"]] for x in out[side]]
    return out


def phase_step(torch, graphs, reps):
    """K5 at the config-5 shapes: the kind window's step measured
    (``measure_step``), the int8 window's with its fused scales; the kind
    window through the plain step with a tol that stops it early; and a
    window with an empty normal partition (the giant tier's generator
    at 262,144 spans, its normal codes dropped) through both, bitwise;
    the kind rank program's issue split (``rank_issue_split``)."""
    import numpy as np

    from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.ops import fold
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        host_subset,
        window_weights_full,
    )
    from microrank_tpu_torch.testing import giant_window

    dev = torch.device("cuda")
    out = {"phase": "step"}
    kind = device_subset(graph_from_numpy(host_subset(graphs["auto/auto"], "kind"), dev), "kind")
    out["kind"] = measure_step(torch, "step/kind", window_sizes(kind), reps)
    int8 = device_subset(graph_from_numpy(host_subset(graphs["auto/int8"], "kind"), dev), "kind")
    out["kind_int8"] = measure_step(torch, "step/kind_int8", window_sizes(int8), reps,
                                    int8.pattern_group)
    # Where the kind rank program's issue goes, with K6's kernels and
    # with its plain versions in turns.
    out["kind_issue_split_ms"] = issue_split_turns(torch, kind, MicroRankConfig(), "kind")
    # K6 at the config-5 kind window, fully timed, and the epilogue's
    # tie / NaN sweep.
    out["k6"] = measure_k6(torch, "step/k6", kind, MicroRankConfig(), "kind", reps)
    out["k6_sweep"] = epilogue_sweep(torch, dev)
    # Where a K6 wrapper call's host time goes inside the kind program:
    # the first design's wrappers part by part against today's, in turns.
    out["k6_host_split"] = k6_host_split(torch, kind, MicroRankConfig(), "kind")
    # The fixed-order fold at the uncollapsed config-5 window's set-up
    # shape (its trace axis; the kind window's columns are few).
    out["fold"] = measure_fold(torch, fold, "step/fold", graphs["auto/off"], reps)
    # tol: the window's joint residual at step 10 as the tolerance.
    residuals = window_weights_full(kind, PageRankConfig(), "kind")[4]
    tol = float(residuals.max(0).values[9])
    cfg = MicroRankConfig(pagerank=PageRankConfig(tol=tol))
    out["kind_tol"] = {"tol": tol, **plain_step_check(torch, kind, cfg, "kind")}
    check(0 < out["kind_tol"]["n_iters"] < STEPS,
          f"step: the tol run did not stop early ({out['kind_tol']['n_iters']})")
    gw = giant_window(262_144, GIANT_OPS)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, np.zeros(0, np.int64), gw.abnormal_codes, aux="packed"
    )
    empty = device_subset(graph_from_numpy(host_subset(graph, "packed"), dev), "packed")
    for key, pr in (("empty_partition", PageRankConfig()),
                    ("empty_partition_tol", PageRankConfig(tol=1e-4))):
        out[key] = plain_step_check(torch, empty, MicroRankConfig(pagerank=pr), "packed")
        check(out[key]["any_nan"], f"step: {key}: the empty partition gave no NaN")
    check(out["empty_partition_tol"]["n_iters"] == 1,
          "step: an empty partition's NaN residual did not stop the tol run")
    return out


def group_step_check(torch, tag, dg, scale_group=None):
    """K5's group kernel at a stacked group's shapes (``dg``, staged):
    chains of REPEATS steps on random inputs through the kernel the main
    path plans (``step_grid_group<S>``; where a thread's values pass its
    slots, with them recomputed too) bitwise the plain step on the card
    and PR 13's kernel: the default configuration; a tol of 1e-4 whose
    odd windows move (their products times the carry) while the even
    ones freeze after their second step, so the windows stop at
    different steps (a gate); with ``scale_group`` (the group's int8
    pattern group) every step's [B, 4] scales. Returns the plan and
    what was compared."""
    from microrank_tpu_torch.ops import step

    dev = torch.device("cuda")
    b = int(dg.normal.kind.shape[0])
    sizes = [(int(p.cov_unique.shape[-1]), int(p.kind.shape[-1]))
             for p in (dg.normal, dg.abnormal)]
    gen = torch.Generator(device=dev).manual_seed(11)
    products, carry, prefs = group_inputs(torch, gen, b, sizes, dev)
    moving = (torch.arange(b, device=dev) % 2 == 1)[:, None]
    cases = {"default": (None, None, False), "tol": (1e-4, moving, False)}
    if scale_group is not None:
        cases["int8"] = (None, None, True)
    out = {"windows": b, "sizes": sizes, "launches_per_chain": REPEATS, "cases": {}}
    for label, (tol, mov, scales) in cases.items():
        def run(mode, hold=True):
            plan = step.step_plan(prefs, 0.01, 0.85, tol, True, step.step_scratch(dev, b),
                                  scale_group if scales else None)
            got, win = group_chain(torch, mode, plan, products, carry, REPEATS, scales,
                                   hold=hold, moving=mov)
            torch.cuda.synchronize()
            check(not plan.scratch.any(), f"{tag}: the group step ({mode}) left its scratch "
                                          "non-zero")
            return got, win

        want, _ = run("plain")
        got, win = run("kernel")
        check(win.grid_plan.kernel == step.KERNEL_GROUP,
              f"{tag}: the group planned {win.grid_plan.kernel_name}")
        check(torch.equal(got, want), f"{tag}: {label}: {win.grid_plan.kernel_name} over "
                                      f"{REPEATS} launches differs from the plain step")
        compared = ["plain", "group_units"]
        old, _ = run("group_units")
        check(torch.equal(old, want), f"{tag}: {label}: PR 13's kernel differs from the plain "
                                      "step")
        if win.grid_plan.held:
            again, _ = run("kernel", hold=False)
            check(torch.equal(again, want),
                  f"{tag}: {label}: the group step recomputing past its slots differs")
            compared.append("recomputed")
        del old
        if tol is not None:
            n_iters = want[-2 * b:-b].tolist()
            check(b < 2 or len(set(n_iters)) > 1,
                  f"{tag}: the tol chain's windows froze at the same step ({n_iters})")
            out["tol_n_iters"] = n_iters
        out["cases"][label] = {"bitwise_vs": compared}
        out["plan"] = win.grid_plan._asdict()
        out["kernel"] = win.grid_plan.kernel_name
    return out


def step_split(torch, spmv, pattern, dg, kernel, reps=20, int8=False):
    """One power-iteration step of a staged graph (a window, or a stacked
    group) split by kernel, on random inputs of its shapes: the route's
    products (the pcsr step; or the pair, K8 and its fold here, then K1's
    call-graph terms) and K5's step (``step_grid<S>`` for a window,
    ``step_grid_group<S>`` for a group; ``int8``: with the group's [B, 4]
    scales), each by CUDA events behind a device spin, the median of
    ``reps`` calls; the plain step beside it. A group's step is timed
    in turns with PR 13's kernel (new, old, old, new) and, where a
    thread's values pass its slots, with them recomputed in place of
    held in shared memory (new, recomputed, old, old, recomputed, new);
    its grid plan (per_thread, slots, grid, units, held) printed."""
    from microrank_tpu_torch.ops import step as step_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    dev = torch.device("cuda")
    lead = tuple(dg.normal.kind.shape[:-1])
    parts = (dg.normal, dg.abnormal)
    svs = [torch.rand(lead + (p.cov_unique.shape[-1],), generator=gen, device=dev) for p in parts]
    rvs = [torch.rand(lead + (p.kind.shape[-1],), generator=gen, device=dev) for p in parts]

    def products():
        if kernel == "pcsr":
            return spmv.pcsr_spmv_group(dg.spmv_group, (rvs[0], svs[0], rvs[1], svs[1]))
        outs = pattern.pattern_pair_group(dg.pattern_group, rvs, svs)
        xs = [sv if x is None else x for sv, (_, _, x) in zip(svs, outs)]
        return outs, spmv.coo_spmv_group(dg.spmv_group, xs)

    ys = tuple((torch.rand_like(sv), torch.rand_like(sv), torch.rand_like(rv))
               for sv, rv in zip(svs, rvs))
    plan = step_mod.step_plan([torch.rand_like(rv) for rv in rvs], 0.01, 0.85, None, True,
                              step_mod.step_scratch(dev, lead[0] if lead else 1),
                              dg.pattern_group if int8 else None)

    def window(**kw):
        return step_mod.StepWindow(plan, tuple(zip(svs, rvs)),
                                   torch.zeros(lead + (2, 1), device=dev), **kw)

    wins = {"new": window(), "plain": window(mode="plain")}
    if lead:
        wins["old"] = window(mode="group_units")
        if wins["new"].grid_plan.held:
            wins["recomputed"] = window(hold=False)
    order = {2: ("new", "old", "old", "new"),
             3: ("new", "recomputed", "old", "old", "recomputed", "new")}.get(
        len(wins) - 1, ("new",))
    turns = [[k, round(spin_event_ms(torch, lambda k=k: wins[k].step(ys, 0, int8), reps), 6)]
             for k in order]
    win = wins["new"]
    out = {
        "products_ms": round(spin_event_ms(torch, products, reps), 6),
        "step_ms": min(t for k, t in turns if k == "new"),
        "plain_step_ms": round(spin_event_ms(torch, lambda: wins["plain"].step(ys, 0, int8),
                                             reps), 6),
        "step_kernel": win.grid_plan.kernel_name,
        "step_grid": win.grid,
        "plan": {k: getattr(win.grid_plan, k)
                 for k in ("per_thread", "slots", "grid", "units", "held")},
        "sizes": [[int(p.cov_unique.shape[-1]), int(p.kind.shape[-1])] for p in parts],
        "windows": lead[0] if lead else 1,
    }
    nbytes, bytes_ms = step_bound(out["sizes"])
    out.update(bound_bytes=out["windows"] * nbytes, bound_ms=round(out["windows"] * bytes_ms, 6))
    if lead:
        out["turns"] = turns
        out["previous_design_ms"] = min(t for k, t in turns if k == "old")
        if "recomputed" in wins:
            out["recomputed_ms"] = min(t for k, t in turns if k == "recomputed")
    return out


def giant_stacked(torch, spmv, pattern, graph, single, kernel, cfg):
    """A giant window stacked twice (``stack_window_graphs``) and ranked
    as one program (K18): the host's stacking time, the group's staging
    (H2D and layouts), its launches (25 of each kernel for the group),
    each window's n_valid, n_iters and ranking against the window's own
    program (rtol 1e-5, bitwise reported), the group through the plain
    step on the card bitwise, the program timed in turns with the two
    windows' own programs (windows, stacked, stacked, windows; CUDA
    events and the host clock behind a spin), its window-axis kernels
    bitwise the window's own launches over 50 launches, and the peak
    device memory while the group is staged and ranked (the window's own
    staged graph resident beside it); a step of the group and of the
    window split by kernel (``step_split``). Returns (counts, info)."""
    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        divide_block_budget,
        host_subset,
    )

    tag = f"giant_stacked/{kernel}"
    one = host_subset(graph, kernel)
    t0 = time.perf_counter()
    stack = stack_window_graphs([one, one])
    stack_ms = (time.perf_counter() - t0) * 1e3
    gcfg = cfg.replace(pagerank=divide_block_budget(cfg.pagerank, kernel, 2))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = device_subset(graph_from_numpy(stack, torch.device("cuda")), kernel,
                         gcfg.pagerank.packed_block_bytes)
    torch.cuda.synchronize()
    staging_ms = (time.perf_counter() - t0) * 1e3
    info, counts = stacked_program(torch, spmv, pattern, tag, card, [single, single], kernel, gcfg)
    peak = torch.cuda.max_memory_allocated()
    info["k6_bitwise_vs_plain_and_first_design"] = k6_bitwise(torch, tag, card, gcfg, kernel)
    info["group_step"] = group_step_check(torch, f"{tag}/group_step", card)
    info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, None, [single, single]))
    info.update({
        "step_split": {"stacked": step_split(torch, spmv, pattern, card, kernel),
                       "window": step_split(torch, spmv, pattern, single, kernel)},
        "stack_host_ms": round(stack_ms, 3),
        "stack_host_bytes": int(sum(a.nbytes for part in (stack.normal, stack.abnormal)
                                    for a in part)),
        "staging_ms": round(staging_ms, 3),
        "resident_before_bytes": resident,
        "peak_device_memory_bytes": peak,
    })
    del card
    torch.cuda.empty_cache()
    info["staging"] = staging_compare(torch, spmv, pattern, f"{tag}/staging", stack, kernel,
                                      cfg, issue_reps=2)
    torch.cuda.empty_cache()
    return counts, info


def phase_giant(torch, spmv, pattern, n_spans, budget, want, reps):
    """One giant window (bench.py's giant tier, ``testing.giant_window``)
    through the lane's own seams, prepare_rank -> launch_rank ->
    finalize_rank, with its partition given: auto must resolve to
    ``want``. Checked tie-aware (top-5) against the float64 sparse
    oracle on the host graph; the stages timed as in window_breakdown;
    one step of the kernel checked against its plain version on the card
    and timed; then the window stacked twice as one program
    (``giant_stacked``). Collapse is off: the oracle ranks uncollapsed
    windows, and bench.py builds its giant window so. Returns (counts,
    kernel measurement, info, the stacked group's counts)."""
    from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
    from microrank_tpu_torch.ops import fold
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.sparse_oracle import rank_window_sparse
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )
    from microrank_tpu_torch.testing import giant_window
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    tag = f"giant window of {n_spans} spans"
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gw = giant_window(n_spans, GIANT_OPS)
    gen_s = time.perf_counter() - t0
    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="off", dense_budget_bytes=budget))
    rca = TableRCA(cfg, device="cuda")
    ms = {}

    # The main path, counted.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(spmv, pattern)
    t0 = time.perf_counter()
    graph, names, kernel = rca.prepare_rank(gw.table, None, gw.normal_codes, gw.abnormal_codes)
    ms["build"] = round((time.perf_counter() - t0) * 1e3, 3)
    t0 = time.perf_counter()
    top, scores, conv = rca.finalize_rank(rca.launch_rank(graph, names, kernel))
    torch.cuda.synchronize()
    ms["launch_and_finalize_cold"] = round((time.perf_counter() - t0) * 1e3, 3)
    counts = read_counts(spmv, pattern)
    main_peak = torch.cuda.max_memory_allocated()
    shapes = budget_inequalities(graph, budget)
    check(kernel == want, f"{tag}: auto resolved to {kernel}, want {want} ({shapes})")
    expect = expected_counts(want, 1, folds=host_folds(pattern, graph))
    check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")

    # The float64 oracle on the host graph.
    t0 = time.perf_counter()
    o_top, o_scores = rank_window_sparse(graph, names, cfg.pagerank, cfg.spectrum)
    oracle_s = time.perf_counter() - t0
    ok, why = tie_aware_topk_agreement(top, scores, o_top, o_scores, k=5, rtol=ORACLE_RTOL)
    check(ok, f"{tag}: top-5 against the float64 oracle: {why}")
    o_score = dict(zip(o_top, o_scores))
    rel = max(abs(s - o_score[n]) / abs(o_score[n]) for n, s in zip(top, scores) if n in o_score)

    # The stages again, warm, the device drained between them.
    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t) * 1e3, 3)
        return out

    dgraph = stage("h2d", lambda: graph_from_numpy(host_subset(graph, kernel), dev))
    dgraph = stage("layouts", lambda: device_subset(dgraph, kernel, cfg.pagerank.packed_block_bytes))

    def rank():
        return rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)

    outs = stage("rank_issue_and_run", rank)
    stage("fetch", lambda: fetch_rank_outputs(outs))
    rank_device = (device_ms(torch, rank, 3),
                   spin_event_host_ms(torch, rank, 3, PROGRAM_SPIN_CYCLES))
    # K5: the window through the plain step, bitwise, and its step at
    # this window's shapes; where the rank
    # program's issue goes.
    plain_step = plain_step_check(torch, dgraph, cfg, kernel)
    step_kern = measure_step(torch, f"giant/{kernel}/step", window_sizes(dgraph), reps)
    issue_split = issue_split_turns(torch, dgraph, cfg, kernel)
    fold_kern = measure_fold(torch, fold, f"giant/{kernel}/fold", graph, reps)
    k6 = measure_k6(torch, f"giant/{kernel}/k6", dgraph, cfg, kernel, reps)
    k13 = measure_k13(torch, f"giant/{kernel}/k13", dgraph, cfg, kernel, reps) \
        if kernel == "pcsr" else None
    k19 = measure_k19(torch, f"giant/{kernel}/k19", dgraph, cfg, kernel, K6_REPS) \
        if kernel == "pcsr" else None
    k15 = measure_k15(torch, f"giant/{kernel}/k15", dgraph, cfg, kernel, K6_REPS)

    # One step of the kernel against its plain version on the card.
    gen = torch.Generator(device=dev).manual_seed(3)
    if kernel == "pcsr":
        pallas = device_subset(graph_from_numpy(graph, dev), "pallas").spmv_group
        kern = measure_pcsr(torch, spmv, f"giant/{kernel}", dgraph, reps, pallas)
        del pallas
    else:
        group = dgraph.pattern_group
        rvs = [torch.rand(p.n_cols, generator=gen, device=dev) for p in group.parts]
        svs = [torch.rand(p.pattern.shape[0], generator=gen, device=dev) for p in group.parts]
        kern = measure_pattern(torch, pattern, f"giant/{kernel}", group, rvs, svs, "f32",
                               cpu_check=False)
        cells = sum(p.pattern.shape[0] * p.n_cols for p in group.parts)
        kern["density_sweep"] = [{
            "density": sum(kern["set_cells"]) / cells, "ms": kern["ms"],
            "previous_design_ms": kern["previous_design_ms"], "bitwise_vs_previous_design": True,
        }] + blocked_density_sweep(torch, pattern, group)
    info = {
        "phase": "giant",
        "spans": gw.table.n_spans,
        "operations": GIANT_OPS,
        "resolved_kernel": kernel,
        "dense_budget": shapes,
        "incidence_entries": [int(p.n_inc) for p in (graph.normal, graph.abnormal)],
        "call_edges": [int(p.n_ss) for p in (graph.normal, graph.abnormal)],
        "launches": counts,
        "top5": list(zip(top[:5], scores[:5])),
        "oracle_top5": list(zip(o_top[:5], o_scores[:5])),
        "top5_tie_aware_vs_oracle": True,
        "oracle_rtol": ORACLE_RTOL,
        "max_rel_score_diff_vs_oracle": rel,
        "rank_iterations": None if conv is None else conv["iterations"],
        "generate_s": round(gen_s, 3),
        "oracle_s": round(oracle_s, 3),
        "stage_ms": ms,
        **rank_device_fields(rank_device, ms["rank_issue_and_run"]),
        "peak_device_memory_bytes_main_path": main_peak,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        "plain_step": plain_step,
        "step": step_kern,
        "fold": fold_kern,
        "k6": k6,
        "issue_split_ms": issue_split,
        "kernel": kern,
    }
    if k13 is not None:
        info["k13"] = k13
    if k19 is not None:
        info["k19"] = k19
    info["k15"] = k15
    info["staging"] = staging_compare(torch, spmv, pattern, f"giant/{kernel}/staging",
                                      host_subset(graph, kernel), kernel, cfg)
    stacked_counts, info["stacked"] = giant_stacked(torch, spmv, pattern, graph, dgraph, kernel,
                                                    cfg)
    return counts, (kern, step_kern, fold_kern, k6), info, stacked_counts


# The kernel families of the families phase (K10-K12), and the stacked
# groups of the replay's windows each is held to.
FAMILY_KERNELS = ("csr", "coo", "dense", "dense_bf16")
FAMILY_STACKS = (2, 6)
# Timed calls of the dense kernel at a window: the uncollapsed window's
# matrices are gigabytes, so fewer calls there, not a smaller window.
DENSE_REPS = {"auto": 50, "off": 5}


def dense_step_check(torch, dgraph, cfg, kernel):
    """A window's rank program (its dense group staged) with every launch
    of the dense kernel held against the plain version on the same
    inputs on the card: each of the 25 steps' six products bitwise.
    Returns (what it checked, the program's fetched outputs)."""
    from microrank_tpu_torch.ops import dense
    from microrank_tpu_torch.rank_backends import torch_cuda

    real = torch_cuda.dense_matvecs
    seen = []

    def checked(group, xs):
        ys = real(group, xs)
        want = dense.dense_matvecs_plain(group, xs)
        seen.append(all(torch.equal(bits(torch, y), bits(torch, w)) for y, w in zip(ys, want)))
        return ys

    torch_cuda.dense_matvecs = checked
    try:
        out = torch_cuda.fetch_rank_outputs(torch_cuda.rank_window_traced_core(
            dgraph, cfg.pagerank, cfg.spectrum, kernel))
    finally:
        torch_cuda.dense_matvecs = real
    check(len(seen) == STEPS and all(seen),
          f"{kernel}: the dense kernel differs from its plain version at launches "
          f"{[i for i, ok in enumerate(seen) if not ok]} of {len(seen)}")
    return {"launches_checked": len(seen), "bitwise_vs_plain_every_launch": True}, out


def measure_dense(torch, name, dgraph, reps):
    """K12 at a window's shapes (its dense group, random vectors): one
    step's six products bitwise the plain version on the card and over
    50 launches, timed by CUDA events behind a spin beside the plain
    version, six ``torch.mv`` (the library yardstick: over the f32
    matrices, or the bf16 ones with the vector cast to bf16, which
    returns bf16) and the bound: each matrix's cells and each vector
    read once, each output written once, at 3.35 TB/s (2 flops a cell at
    67 TFLOP/s)."""
    from microrank_tpu_torch.ops import dense

    group = dgraph.spmv_group
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lead = () if group.windows is None else (group.windows,)
    v = int(dgraph.normal.cov_unique.shape[-1])
    sizes = (int(dgraph.normal.kind.shape[-1]), v, int(dgraph.abnormal.kind.shape[-1]), v)
    xs = [torch.rand(lead + (n,), generator=gen, device=dev) for n in sizes]
    first = torch.cat([y.reshape(-1) for y in dense.dense_matvecs(group, xs)])
    want = torch.cat([y.reshape(-1) for y in dense.dense_matvecs_plain(group, xs)])
    check(torch.equal(bits(torch, first), bits(torch, want)),
          f"{name}: the dense kernel differs from its plain version on the card")
    again = [torch.cat([y.reshape(-1) for y in dense.dense_matvecs(group, xs)])
             for _ in range(REPEATS)]
    check(all(torch.equal(bits(torch, a), bits(torch, first)) for a in again),
          f"{name}: the dense kernel is not bitwise repeatable over {REPEATS} launches")
    del again
    mats = [m[..., :n] for m, n in zip(group.mats, group.n_cols)]
    mx = [xs[s] for s in group.x_slots]
    lib_x = [x.to(torch.bfloat16) if group.bf16 else x for x in mx]
    calls = {
        "kernel": lambda: dense.dense_matvecs(group, xs),
        "plain": lambda: dense.dense_matvecs_plain(group, xs),
        "library": lambda: [torch.mv(m, x) for m, x in zip(mats, lib_x)],
    }
    lib_diff = float(max(((torch.mv(m, x).float() - y).abs().max() / y.abs().max().clamp_min(1e-30))
                         for m, x, y in zip(mats, lib_x, dense.dense_matvecs(group, xs))))
    ms = {k: spin_event_ms(torch, calls[k], reps if k != "plain" else max(1, reps // 5))
          for k in ("kernel", "plain", "library")}
    elt = 2 if group.bf16 else 4
    cells = sum(int(m.shape[-2]) * n for m, n in zip(group.mats, group.n_cols))
    rows = sum(int(m.shape[-2]) for m in group.mats)
    n_win = group.windows or 1
    nbytes = n_win * (cells * elt + 4 * sum(sizes) + 4 * rows)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n_win * cells / F32_FLOPS_PER_S * 1e3
    return {
        "name": name,
        "precision": "bf16" if group.bf16 else "f32",
        "shapes": [list(m.shape) for m in group.mats],
        "cols": list(group.n_cols),
        "matrix_bytes": int(sum(m.numel() * m.element_size() for m in group.mats)),
        "ms": round(ms["kernel"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
        "tb_per_s": round(nbytes / ms["kernel"] / 1e9, 3),
        "max_abs_err": 0.0,
        "library_max_rel_diff": lib_diff,
        "bitwise_vs_plain": True,
        "bitwise_repeatable_launches": REPEATS,
        "reps": reps,
    }


def issue_without_sync(torch, tag, host, kernel, cfg, checked=False):
    """One window's staging (the blob), layouts, program and output copy
    under ``torch.cuda.set_sync_debug_mode("error")``, which must not
    raise: nothing between the blob's copy and the output copy waits on
    the card. Returns the fetched outputs."""
    from microrank_tpu_torch.rank_backends import blob
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        host_subset,
        pack_rank_outputs,
        unpack_rank_outputs,
    )

    one = host_subset(host, kernel)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, staged = blob.stage_rank_window(one, cfg.pagerank, cfg.spectrum, kernel,
                                              torch.device("cuda"), True, checked=checked,
                                              conv_trace=True)
        packed = pack_rank_outputs(outs, staged, checked=checked)
    except RuntimeError as exc:
        raise PhaseError(f"{tag}: the {kernel} route synced between its blob copy and its "
                         f"output copy: {str(exc).splitlines()[0]}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return unpack_rank_outputs(packed)


def family_run(torch, spmv, pattern, case, normal, abnormal, kernel, collapse, cpu_ref,
               pallas_res, keep=None):
    """One family's run of the lane at config 5 (``run_rca_native`` with
    ``kernel``, collapse ``collapse``): top-1, the resolved kernel, the
    launches, agreement with a CPU run: tie-aware at rtol 1e-5 with the
    same function there (``cpu_ref``, the port's coo route on the CPU:
    csr, coo, dense), tie-aware at 5e-3 with the route's own plain path
    (dense_bf16 collapsed); uncollapsed, dense_bf16's CPU plain path
    would read its gigabytes 25 times on the host, so it is held to
    ``cpu_ref`` by JAX's bf16 rank parity (``tests/test_properties.py``:
    the same top-1, top-3 and top-k set; the scores' largest relative
    difference reported), its kernel held bitwise to the plain version
    on the card on every launch below; coo bitwise the pinned pallas run
    (``pallas_res``); then the
    window through the lane's seams (stage times, the program's device
    time by events), the sync check, and the route's kernel at the
    window: the dense kernel bitwise its plain version on every launch of
    the 25 steps and timed; K10 (csr) bitwise its plain version and timed
    (``measure_csr_scan``); K1 over the coo work list timed uncollapsed
    (``measure_group``). ``keep``: a dict the window's host graph is
    kept in, under the run's tag (the explain phase's K15 reads it)."""
    from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.rank_backends.torch_cuda import spmv_layouts
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    tag = f"families/{kernel}/{collapse}"
    cfg = MicroRankConfig(runtime=RuntimeConfig(kernel=kernel, collapse_kinds=collapse))
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    t0 = time.perf_counter()
    res = run_rca_native(normal, abnormal, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(spmv, pattern)
    ranked = [r for r in res if r.ranking]
    check(ranked, f"{tag}: no window was ranked")
    check({r.kernel for r in ranked} == {kernel}, f"{tag}: ranked with {[r.kernel for r in ranked]}")
    top1 = ranked[0].ranking[0][0]
    check(top1 == case.fault_pod_op, f"{tag}: top-1 {top1} is not the fault {case.fault_pod_op}")
    n = len(ranked)
    expect = expected_counts(kernel, n)
    check(counts == expect, f"{tag}: launch counts {counts} in {n} ranked windows, want {expect}")
    rank_parity = kernel == "dense_bf16" and collapse == "off"
    rtol = RUN_RTOL
    against = "the port's coo route on the CPU"
    if kernel == "dense_bf16" and not rank_parity:
        t1 = time.perf_counter()
        cpu_ref = run_rca_native(normal, abnormal, cfg, device="cpu")
        own_cpu_s = time.perf_counter() - t1
        rtol, against = RUN_RTOL_BF16, f"its own plain path on the CPU ({own_cpu_s:.3f} s)"
    check(len(res) == len(cpu_ref), f"{tag}: CPU and CUDA runs saw different windows")
    max_rel = 0.0
    for rg, rc in zip(res, cpu_ref):
        check((rg.start, rg.anomaly, rg.n_normal, rg.n_abnormal, rg.rank_iterations)
              == (rc.start, rc.anomaly, rc.n_normal, rc.n_abnormal, rc.rank_iterations),
              f"{tag}: window {rg.start} differs from the CPU run")
        names_g, names_c = [n_ for n_, _ in rg.ranking], [n_ for n_, _ in rc.ranking]
        if rank_parity:
            check(names_g[:3] == names_c[:3] and set(names_g) == set(names_c),
                  f"{tag}: window {rg.start}: bf16 rank parity with the f32 CPU run: "
                  f"{names_g} vs {names_c}")
            by_name = dict(rc.ranking)
            max_rel = max([max_rel] + [abs(sc - by_name[nm]) / max(abs(by_name[nm]), 1e-30)
                                       for nm, sc in rg.ranking])
            continue
        ok, why = tie_aware_topk_agreement(
            names_g, [s for _, s in rg.ranking], names_c, [s for _, s in rc.ranking],
            k=len(rg.ranking), rtol=rtol)
        check(ok, f"{tag}: window {rg.start}: CUDA vs CPU ranking: {why}")
    info = {"kernel": kernel, "collapse_kinds": collapse, "windows": len(res), "ranked": n,
            "top5": ranked[0].ranking[:5], "top1_is_fault": True, "launches": counts,
            "cuda_vs_cpu": against,
            "cuda_vs_cpu_rule": ("JAX's bf16 rank parity: top-1, top-3, the set" if rank_parity
                                 else f"tie-aware, rtol {rtol}"),
            "cuda_wall_s_per_window": round(wall / len(res), 4)}
    if rank_parity:
        info["bf16_vs_f32_max_rel_score_diff"] = max_rel
    if kernel == "coo":
        check([(r.start, r.ranking, r.rank_iterations) for r in res]
              == [(r.start, r.ranking, r.rank_iterations) for r in pallas_res],
              f"{tag}: the ranking is not bitwise the pinned pallas run's")
        info["ranking_bitwise_vs_pallas"] = True
    graph, _, stages, rank_device, dgraph = window_breakdown(
        torch, cfg, normal, abnormal, ranked[0].start)
    if keep is not None:
        keep[tag] = graph
    info["shapes"] = graph_shapes(graph)
    info["stage_ms"] = stages
    info.update(rank_device_fields(rank_device, stages["rank_issue_and_run"]))
    fetched = issue_without_sync(torch, tag, graph, kernel, cfg)
    check([float(x) for x in fetched[1][: fetched[2]]] == [sc for _, sc in ranked[0].ranking]
          and fetched[4] == ranked[0].rank_iterations,
          f"{tag}: the window issued under the sync check ranks otherwise than the lane")
    info["issues_without_host_sync"] = True
    if kernel in ("dense", "dense_bf16"):
        info["dense_steps"], _ = dense_step_check(torch, dgraph, cfg, kernel)
        info["dense"] = measure_dense(torch, tag, dgraph, DENSE_REPS[collapse])
    elif kernel == "csr":
        # K10 at the window (collapsed too: its CSR views are the same
        # matrices the route's program read), held bitwise its plain
        # version, timed uncollapsed.
        info["csr_scan"] = measure_csr_scan(torch, spmv, tag, dgraph)
    elif collapse == "off":
        gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
        layouts = [*spmv_layouts(dgraph.normal), *spmv_layouts(dgraph.abnormal)]
        v = int(dgraph.normal.cov_unique.shape[0])
        sizes = (int(dgraph.normal.kind.shape[0]), v, int(dgraph.abnormal.kind.shape[0]), v)
        xs = [torch.rand(k, generator=gen, device=torch.device("cuda")) for k in sizes]
        info["k1"] = measure_group(torch, spmv, tag, dgraph.spmv_group, layouts, xs)
    del dgraph
    torch.cuda.empty_cache()
    return counts, info


def family_stacks(torch, spmv, pattern, replay, windows):
    """Each family's stacked groups of the replay's windows (B = 2 and
    6, as ``prepare_rank`` builds each window for the kernel, collapsed
    as the replay runs): one program a group, bitwise each window's own
    program, one window's launches a group."""
    import numpy as np

    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )

    tl, normal_table, table, _ = replay
    dev = torch.device("cuda")
    launches, out = {}, {}

    def us(iso):
        return int(np.datetime64(iso, "us").astype(np.int64))

    for kernel in FAMILY_KERNELS:
        cfg = replay_config(tl, kernel=kernel)
        rca = TableRCA(cfg, device="cuda")
        rca.fit_baseline(normal_table)
        admitted, _ = admit_table(table, cfg.ingest, source="table")
        host = []
        for r in (r for r in windows if r.ranking):
            mask, nrm, abn, _, row_range = rca._detect_window(admitted, us(r.start), us(r.end))
            graph, _, resolved = rca.prepare_rank(admitted, mask, nrm, abn, row_range)
            check(resolved == kernel, f"families/stacked: window {r.start} resolved to {resolved}")
            host.append(host_subset(graph, kernel))

        def program(g):
            dg = device_subset(graph_from_numpy(g, dev), kernel)
            return fetch_rank_outputs(rank_window_traced_core(dg, cfg.pagerank, cfg.spectrum,
                                                              kernel))

        own = [program(g) for g in host]
        out[kernel] = {}
        for b in FAMILY_STACKS:
            if b > len(host):
                continue
            tag = f"families/stacked/{kernel}/{b}"
            stack = stack_window_graphs(host[:b])
            torch.cuda.synchronize()
            reset_counts(spmv, pattern)
            got = program(stack)
            counts = read_counts(spmv, pattern)
            expect = expected_counts(kernel, b, programs=1, groups=1)
            check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")
            for w in range(b):
                check((int(got[2][w]), int(got[4][w])) == (own[w][2], own[w][4])
                      and all(x.tobytes() == y.tobytes() for x, y in
                              ((got[0][w], own[w][0]), (got[1][w], own[w][1]),
                               (got[3][w], own[w][3]))),
                      f"{tag}: window {w} is not bitwise its own program")
            launches[tag] = counts
            out[kernel][str(b)] = {"bits_vs_own": True, "launches": counts}
        torch.cuda.empty_cache()
    return launches, out


def family_checks(torch, spmv, pattern, graphs, replay, windows):
    """K14, the checked program, at config 5: the replay with
    ``device_checks`` (synchronous, per window) ranks bitwise what the
    sync replay ranked; the config-5 window poisoned as
    ``tests/test_sanitizers.py`` poisons it (``abnormal.sr_val[0]`` NaN)
    raises ``DeviceCheckError`` with "non-finite" on the coo and dense
    routes, with no host sync from the blob's copy to the output copy;
    the epilogue checked (the word over the ranking and the residual
    trace) and unchecked at the config-5 kind window, timed in turns
    (unchecked, checked, checked, unchecked), its outputs bitwise."""
    import numpy as np

    from microrank_tpu_torch.config import MicroRankConfig
    from microrank_tpu_torch.ops import epilogue
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends import torch_cuda
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy

    info = {}
    if replay is not None:
        tl, normal_table, table, _ = replay
        rca = TableRCA(replay_config(tl, device_checks=True, **REPLAY_MODES["sync"]),
                       device="cuda")
        rca.fit_baseline(normal_table)
        t0 = time.perf_counter()
        checked = rca.run(table)
        wall = time.perf_counter() - t0
        check([(r.start, r.ranking, r.rank_iterations) for r in checked]
              == [(r.start, r.ranking, r.rank_iterations) for r in windows],
              "families/checks: the checked replay is not bitwise the sync replay")
        info["replay_bitwise_vs_unchecked"] = True
        info["replay_ranked"] = sum(1 for r in checked if r.ranking)
        info["replay_checked_wall_s"] = round(wall, 3)
    cfg = MicroRankConfig()
    host = graphs["pallas/off"]
    bad = np.asarray(host.abnormal.sr_val).copy()
    bad[0] = np.nan
    poisoned = host._replace(abnormal=host.abnormal._replace(sr_val=bad))
    traps = {}
    for kernel in ("coo", "dense"):
        try:
            issue_without_sync(torch, f"families/checks/{kernel}", poisoned, kernel, cfg,
                               checked=True)
        except torch_cuda.DeviceCheckError as exc:
            check("non-finite" in str(exc), f"families/checks: {kernel}: {exc}")
            traps[kernel] = str(exc)
        else:
            raise PhaseError(f"families/checks: the poisoned window ranked on {kernel} "
                             "without a DeviceCheckError")
        clean = issue_without_sync(torch, f"families/checks/{kernel}", host, kernel, cfg,
                                   checked=True)
        check(clean[2] > 0, f"families/checks: {kernel}: the clean window ranked nothing")
    info["nan_trap"] = traps
    # The epilogue checked and unchecked at the config-5 kind window.
    dg = torch_cuda.device_subset(
        graph_from_numpy(torch_cuda.host_subset(graphs["auto/auto"], "kind"),
                         torch.device("cuda")), "kind")
    prog = torch_cuda._rank_program(dg, cfg.pagerank, cfg.spectrum, "kind")
    args = (dg.normal, dg.abnormal, prog.sv_n, prog.sv_a, cfg.spectrum)
    plain = epilogue.rank_epilogue(*args)
    got, word = epilogue.rank_epilogue_checked(*args, prog.residuals, prog.n_iters)
    torch.cuda.synchronize()
    check(int(word) == 0, f"families/checks: the kind window's check word is {int(word)}")
    check(torch.equal(epilogue_bits(torch, got), epilogue_bits(torch, plain)),
          "families/checks: the checked epilogue's outputs are not the unchecked launch's")
    calls = {"unchecked": lambda: epilogue.rank_epilogue(*args),
             "checked": lambda: epilogue.rank_epilogue_checked(*args, prog.residuals,
                                                                prog.n_iters)}
    turns = [(k, spin_event_ms(torch, calls[k], K6_REPS))
             for k in ("unchecked", "checked", "checked", "unchecked")]
    info["epilogue_turns_ms"] = [[k, round(t, 6)] for k, t in turns]
    info["epilogue_ms"] = {k: round(_mean([t for kk, t in turns if kk == k]), 6)
                           for k in ("unchecked", "checked")}
    info["epilogue_checked_bitwise_unchecked"] = True
    return info


def phase_families(torch, spmv, pattern, case, normal, abnormal, graphs, results, replay,
                   windows):
    """The csr, coo and dense families (K10-K12) and the checked program
    (K14) on ``cli run``'s table lane at config 5: each family collapsed
    ("auto", what ``--kernel X`` builds by default) and not ("off", where
    dense holds the multi-GiB matrices) through ``run_rca_native``
    (``family_run``), each family's stacked groups of the replay's
    windows (``family_stacks``), and the checked program
    (``family_checks``). Each run's window graph lands in ``graphs``
    under ``families/<kernel>/<collapse>``."""
    from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import run_rca_native

    t0 = time.perf_counter()
    cpu, cpu_s = {}, {}
    for collapse in ("auto", "off"):
        t1 = time.perf_counter()
        cpu[collapse] = run_rca_native(normal, abnormal, MicroRankConfig(
            runtime=RuntimeConfig(kernel="coo", collapse_kinds=collapse)), device="cpu")
        cpu_s[collapse] = round(time.perf_counter() - t1, 3)
    launches, runs = {}, {}
    for kernel in FAMILY_KERNELS:
        for collapse in ("auto", "off"):
            counts, info = family_run(torch, spmv, pattern, case, normal, abnormal, kernel,
                                      collapse, cpu[collapse], results[f"pallas/{collapse}"],
                                      keep=graphs)
            launches[f"families/{kernel}/{collapse}"] = counts
            runs[f"{kernel}/{collapse}"] = info
    stacked = None
    if replay is not None:
        stacked_launches, stacked = family_stacks(torch, spmv, pattern, replay, windows)
        launches.update(stacked_launches)
    checks = family_checks(torch, spmv, pattern, graphs, replay, windows)
    return launches, {
        "phase": "families",
        "runs": runs,
        "stacked": stacked,
        "checks": checks,
        "cpu_reference_s": cpu_s,
        "nvidia_smi": power_line(),
        "phase_s": round(time.perf_counter() - t0, 3),
    }


# The JAX CLI's eval defaults (``cli eval``: 30 operations, 400 traces,
# 48 trace kinds, keep-prob 0.15, one 2-second fault, seed 1000).
EVAL_CLI = dict(n_operations=30, n_traces=400, n_kinds=48, child_keep_prob=0.15)
EVAL_CASES = 20           # cli eval's --cases default
EVAL_ALL_METHODS_CASES = 50  # EVALUATION.md's 13-formula table (--all-methods --cases 50)
EVAL_OVERLAP_CASES = 10   # two-fault cases an overlap
EVAL_TIMELINES = 10       # --detection timelines (10 windows each)
EVAL_FULL_CASES = 2       # cases at config-5 scale


def report_fields(rep):
    """An EvalReport as plain data, field for field and case by case."""
    import dataclasses

    return {"cases": [dataclasses.asdict(c) for c in rep.cases],
            "recall_at": {str(k): v for k, v in rep.recall_at.items()},
            "exam_score": rep.exam_score, "exam_score_paper": rep.exam_score_paper,
            "detection_rate": rep.detection_rate}


def report_scores(rep):
    """R@k, both Exam Scores and the detection rate of a report, and its
    summary line."""
    f = report_fields(rep)
    return {k: f[k] for k in ("recall_at", "exam_score", "exam_score_paper",
                              "detection_rate")} | {"summary": rep.summary()}


def eval_expected_counts(timings, all_methods=False):
    """The launch counts of an eval run on the card: one program a
    detected case, on the kernel its build resolved (``timings``'
    "kernel"), summed."""
    total = expected_counts("kind", 0)
    for t in timings:
        if "kernel" in t:
            one = expected_counts(t["kernel"], 1, all_methods=all_methods)
            total = {k: total[k] + one[k] for k in total}
    return total


def phase_eval(torch, spmv, pattern, args):
    """The accuracy harness (``evaluation``) on the card and with
    ``device="cpu"`` (the plain versions), reports equal field for field
    and case by case: ``evaluate`` at the JAX CLI's defaults (20 cases),
    ``evaluate_all_methods`` at EVALUATION.md's 13-formula setting (50
    cases), ``evaluate_overlap_ablation`` (2 faults, 10 cases an overlap)
    and ``evaluate_detection`` (10 timelines); each card run's launches
    gated (one program a detected case on the kernel it resolved; K13's
    launch, one a case, in the all-methods run). Then ``evaluate`` and
    ``evaluate_all_methods`` at config-5 scale on the card (2 cases:
    ``phase_data``'s configuration, seeds 0 and 1, ``n_traces`` for about
    ``--spans`` spans a window), each case's seconds by stage and the
    culprits' ranks. Returns (the main paths' counts, the line)."""
    import dataclasses

    from microrank_tpu_torch import evaluation as ev
    from microrank_tpu_torch.config import MicroRankConfig
    from microrank_tpu_torch.spectrum.formulas import METHODS
    from microrank_tpu_torch.testing.synthetic import SyntheticConfig, _traces_for_spans

    cfg = MicroRankConfig()
    out, launches = {"phase": "eval"}, {}

    def on_card(tag, fn, all_methods=False, **kw):
        timings = []
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        rep = fn(cfg, device="cuda", timings=timings, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(spmv, pattern)
        expect = eval_expected_counts(timings, all_methods)
        check(counts == expect, f"eval/{tag}: launch counts {counts}, want {expect}")
        check(counts["epilogue_launches"] > 0, f"eval/{tag}: no program ran")
        launches[f"eval/{tag}"] = counts
        return rep, timings, wall

    def with_cpu(tag, fn, all_methods=False, **kw):
        card, timings, card_s = on_card(tag, fn, all_methods, **kw)
        t0 = time.perf_counter()
        cpu = fn(cfg, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        reps = card if all_methods else {"": card}
        cpus = cpu if all_methods else {"": cpu}
        for key in reps:
            check(report_fields(reps[key]) == report_fields(cpus[key]),
                  f"eval/{tag}{'/' + key if key else ''}: the card's report is not the CPU's")
        kernels = sorted({t["kernel"] for t in timings if "kernel" in t})
        return card, {"card_s": round(card_s, 3), "cpu_s": round(cpu_s, 3),
                      "kernels": kernels, "reports_equal_card_cpu": True}

    ecfg = ev.EvalConfig(n_cases=EVAL_CASES, **EVAL_CLI)
    rep, info = with_cpu("evaluate", ev.evaluate, eval_cfg=ecfg)
    out["evaluate"] = {**info, **report_scores(rep)}
    ecfg = ev.EvalConfig(n_cases=EVAL_ALL_METHODS_CASES, **EVAL_CLI)
    reps, info = with_cpu("all_methods", ev.evaluate_all_methods, all_methods=True,
                          eval_cfg=ecfg)
    check(list(reps) == list(METHODS), "eval/all_methods: the formulas are not METHODS")
    out["all_methods"] = {**info, "by_method": {m: report_scores(r) for m, r in reps.items()}}
    # The overlap ablation: evaluate per overlap (its timings are not
    # taken through), the card's and the CPU's reports.
    ecfg = ev.EvalConfig(n_cases=EVAL_OVERLAP_CASES, n_faults=2, **EVAL_CLI)
    reset_counts(spmv, pattern)
    t0 = time.perf_counter()
    card = ev.evaluate_overlap_ablation(cfg, ecfg, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = read_counts(spmv, pattern)
    detected = sum(c.detected for r in card.values() for c in r.cases)
    check(counts["epilogue_launches"] == counts["setup_launches"] == detected > 0
          and counts["step_launches"] == STEPS * detected,
          f"eval/overlap_ablation: launch counts {counts} for {detected} detected cases")
    launches["eval/overlap_ablation"] = counts
    t0 = time.perf_counter()
    cpu = ev.evaluate_overlap_ablation(cfg, ecfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    for ov in card:
        check(report_fields(card[ov]) == report_fields(cpu[ov]),
              f"eval/overlap_ablation/{ov}: the card's report is not the CPU's")
    out["overlap_ablation"] = {"card_s": round(card_s, 3), "cpu_s": round(cpu_s, 3),
                               "reports_equal_card_cpu": True,
                               "by_overlap": {str(ov): report_scores(r) for ov, r in card.items()}}
    # Detection runs the C++ detector on the host whatever the device (K16,
    # the device detector, is unported): device="cuda" and device="cpu"
    # are both host runs, gated equal, and nothing here is the card's.
    ecfg = ev.EvalConfig(n_cases=EVAL_TIMELINES, **EVAL_CLI)
    on_cuda = ev.evaluate_detection(cfg, ecfg, device="cuda")
    on_cpu = ev.evaluate_detection(cfg, ecfg, device="cpu")
    check(dataclasses.asdict(on_cuda) == dataclasses.asdict(on_cpu),
          "eval/detection: device='cuda' and device='cpu' count differently")
    out["detection"] = {**dataclasses.asdict(on_cuda), "precision": on_cuda.precision,
                        "recall": on_cuda.recall, "f1": on_cuda.f1,
                        "summary": on_cuda.summary(), "runs_on": "host",
                        "reports_equal_device_cuda_and_cpu": True}
    # Config-5 scale, on the card only.
    syn = SyntheticConfig(n_operations=args.ops, n_kinds=max(32, args.ops // 50),
                          child_keep_prob=0.55, fault_latency_ms=60000.0, seed=0)
    ecfg = ev.EvalConfig(n_cases=EVAL_FULL_CASES, n_operations=args.ops,
                         n_traces=_traces_for_spans(syn, args.spans),
                         n_kinds=syn.n_kinds, child_keep_prob=syn.child_keep_prob,
                         fault_latency_ms=syn.fault_latency_ms, seed0=0)
    full = {"config": dataclasses.asdict(ecfg)}
    for tag, fn, all_methods in (("evaluate", ev.evaluate, False),
                                 ("all_methods", ev.evaluate_all_methods, True)):
        rep, timings, wall = on_card(f"full/{tag}", fn, all_methods, eval_cfg=ecfg)
        first = rep if not all_methods else rep["dstar2"]
        check(all(c.detected for c in first.cases), f"eval/full/{tag}: a case went undetected")
        check(first.cases[0].ranks == [1],
              f"eval/full/{tag}: seed 0's culprit ranks {first.cases[0].ranks}, not 1")
        cases = [{**{k: (round(v, 3) if k.endswith("_s") else v) for k, v in t.items()},
                  "ranks": ({m: r.cases[i].ranks for m, r in rep.items()} if all_methods
                            else rep.cases[i].ranks),
                  "n_ranked_ops": first.cases[i].n_ranked_ops}
                 for i, t in enumerate(timings)]
        full[tag] = {"wall_s": round(wall, 3), "cases": cases,
                     **({"by_method": {m: report_scores(r) for m, r in rep.items()}}
                        if all_methods else report_scores(rep))}
    out["full_width"] = full
    return launches, out


def k13_bound(dgraph, k):
    """K13's bytes and operations for the function it computes
    (``rank_window_all_methods_core``'s triple): each partition's sv,
    op_present and cov_unique read (9 bytes an op), the 13 rows of k
    (index, score) and n_valid written; about 40 float operations an op
    for the finish and the counters and 8 a formula."""
    v = dgraph.normal.op_present.shape[-1]
    return 2 * 9 * v + 13 * 8 * k + 4, (40 + 13 * 8) * v


def selection_sweep(torch, g_n, g_a, svs, cfg, v, reps):
    """The top-k's two selections past the warp-select at the window's
    carries, k from 33 to V: the one-formula epilogue and K13 with the
    sort and with the radix select, bitwise each other, timed in turns
    (radix, sort, sort, radix) by CUDA events behind a spin; and the
    least share k / V from which on the sort never ran slower in either
    (the plan's ``SORT_SHARE`` is fixed from it)."""
    import dataclasses

    from microrank_tpu_torch.ops import epilogue

    ks = sorted({k for k in (33, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048, v // 2, v)
                 if 32 < k <= v})
    rows = []
    for k in ks:
        sp = dataclasses.replace(cfg.spectrum, top_max=k, extra_rows=0)
        calls = {}
        for sel in ("radix", "sort"):
            calls[f"one_{sel}"] = (lambda sel=sel: epilogue.rank_epilogue(
                g_n, g_a, *svs, sp, select=sel))
            calls[f"k13_{sel}"] = (lambda sel=sel: epilogue.rank_epilogue_all_methods(
                g_n, g_a, *svs, sp, select=sel))
        for kind in ("one", "k13"):
            a, b = calls[f"{kind}_radix"](), calls[f"{kind}_sort"]()
            check(torch.equal(epilogue_bits(torch, a), epilogue_bits(torch, b)),
                  f"selection sweep k={k}: {kind}'s sort differs from its radix select")
        turns = {key: [] for key in calls}
        for key in ("one_radix", "one_sort", "k13_radix", "k13_sort",
                    "k13_sort", "k13_radix", "one_sort", "one_radix"):
            turns[key].append(spin_event_ms(torch, calls[key], reps))
        rows.append({"k": k, "share": round(k / v, 6),
                     **{f"{key}_ms": round(_mean(val), 6) for key, val in turns.items()}})
    share = next((r["share"] for i, r in enumerate(rows)
                  if all(x["one_sort_ms"] <= x["one_radix_ms"]
                         and x["k13_sort_ms"] <= x["k13_radix_ms"] for x in rows[i:])), None)
    return {"rows": rows, "sort_share_measured": share, "plan_sort_share": epilogue.SORT_SHARE}


def measure_k13(torch, name, dgraph, cfg, kernel, reps):
    """K13 at a staged window's shapes, on its program's final carries,
    at k = n_rows and k = V: bitwise its plain version run on the card,
    its previous selection (the radix select past the warp-select) and
    over 50 launches; row m bitwise the one-formula epilogue launch of
    formula m; timed by CUDA events behind a spin in turns (K13, K13
    with the previous selection, 13 one-formula launches, one, one with
    the previous selection, and back) beside the plain version, the
    bound (bytes once at 3.35 TB/s, or the operations at 67 TFLOP/s) and
    the top-k alone as one stable ``torch.sort`` of the [13, V] negated
    scores; the selections' sweep over k (``selection_sweep``); then the
    whole all-methods program in turns with 13 one-formula programs."""
    import dataclasses

    from microrank_tpu_torch.ops import epilogue
    from microrank_tpu_torch.rank_backends import torch_cuda as tc
    from microrank_tpu_torch.spectrum.formulas import METHODS, spectrum_scores

    pr = cfg.pagerank
    g_n, g_a = dgraph.normal, dgraph.abnormal
    v = int(g_n.op_present.shape[-1])
    program = tc._rank_program(dgraph, pr, cfg.spectrum, kernel)
    svs = (program.sv_n, program.sv_a)
    out = {"v": v}
    for label, top_max in (("k_n_rows", cfg.spectrum.top_max), ("k_v", v)):
        sp = dataclasses.replace(cfg.spectrum, top_max=top_max)
        k = min(sp.n_rows, v)
        card = epilogue.kernel_config(g_n.op_present.device)
        plan = epilogue.epilogue_plan(v, k, 1, card)
        # The selection before this PR: the radix select past the
        # warp-select (which is unchanged).
        prev = "radix" if k > card.warp_k else None
        every = epilogue.rank_epilogue_all_methods(g_n, g_a, *svs, sp)
        got = epilogue_bits(torch, every)
        check(torch.equal(got, epilogue_bits(torch, epilogue.rank_epilogue_plain(
            g_n, g_a, *svs, sp, all_methods=True))), f"{name}/{label}: K13 differs from its "
                                                     "plain version")
        check(torch.equal(got, epilogue_bits(torch, epilogue.rank_epilogue_all_methods(
            g_n, g_a, *svs, sp, select=prev))), f"{name}/{label}: K13 differs from its "
                                                "previous selection")
        for _ in range(REPEATS):
            check(torch.equal(epilogue_bits(torch, epilogue.rank_epilogue_all_methods(
                g_n, g_a, *svs, sp)), got), f"{name}/{label}: K13 is not repeatable")
        ones = [dataclasses.replace(sp, method=m) for m in METHODS]
        for m, one_cfg in enumerate(ones):
            one = epilogue.rank_epilogue(g_n, g_a, *svs, one_cfg)
            row = every._replace(top_idx=every.top_idx[m], top_scores=every.top_scores[m])
            check(torch.equal(epilogue_bits(torch, row), epilogue_bits(torch, one)),
                  f"{name}/{label}: row {m} ({METHODS[m]}) is not the one-formula launch's")
        # The top-k's library yardstick: the [13, V] scores as the plain
        # version gives them, negated, one stable sort.
        plain = epilogue.rank_epilogue_plain(g_n, g_a, *svs, sp)
        counters = epilogue.spectrum_counters(plain.a_weight, g_a, plain.n_weight, g_n, sp)
        valid = counters[-1]
        neg = -(torch.stack([torch.where(valid, spectrum_scores(*counters[:4], m),
                                         float("-inf")) for m in METHODS]) + 0.0)

        sides = {
            "k13": lambda: epilogue.rank_epilogue_all_methods(g_n, g_a, *svs, sp),
            "k13_previous": lambda: epilogue.rank_epilogue_all_methods(g_n, g_a, *svs, sp,
                                                                       select=prev),
            "thirteen": lambda: [epilogue.rank_epilogue(g_n, g_a, *svs, one_cfg)
                                 for one_cfg in ones],
            "one": lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp),
            "one_previous": lambda: epilogue.rank_epilogue(g_n, g_a, *svs, sp, select=prev),
        }
        turns = {key: [] for key in sides}
        for side in ("k13", "k13_previous", "thirteen", "one", "one_previous",
                     "one_previous", "one", "thirteen", "k13_previous", "k13"):
            turns[side].append(spin_event_ms(torch, sides[side], reps))
        nbytes, flops = k13_bound(dgraph, k)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        # Where the one-formula launch's time goes: the SM cycles between
        # its phases (the median of 9 calls; the selection's on either
        # side of the plan).
        phase_cycles = {}
        for side, sel in (("plan", None), ("previous_selection", prev)):
            stamps = torch.zeros(epilogue.STAMPS, dtype=torch.int64, device=svs[0].device)
            cycles = []
            for _ in range(9):
                epilogue.rank_epilogue(g_n, g_a, *svs, sp, stamps=stamps, select=sel)
                c = stamps.tolist()
                cycles.append([c[i + 1] - c[i] for i in range(epilogue.STAMPS - 1)])
            phase_cycles[side] = dict(zip(EPILOGUE_PHASES, (
                int(_median([row[i] for row in cycles])) for i in range(epilogue.STAMPS - 1))))
        out[label] = {
            "k": k, "plan": plan._asdict(), "previous_selection": prev or "warp (unchanged)",
            "phase_cycles": phase_cycles,
            "bitwise_vs_plain": True, "bitwise_vs_previous_selection": True,
            "repeat_bitwise": REPEATS,
            "rows_bitwise_vs_one_formula_launches": len(METHODS), "max_abs_err": 0.0,
            "turns_ms": {key: [round(x, 6) for x in val] for key, val in turns.items()},
            "ms": round(_mean(turns["k13"]), 6),
            "previous_selection_ms": round(_mean(turns["k13_previous"]), 6),
            "thirteen_launches_ms": round(_mean(turns["thirteen"]), 6),
            "one_launch_ms": round(_mean(turns["one"]), 6),
            "one_launch_previous_selection_ms": round(_mean(turns["one_previous"]), 6),
            "plain_ms": round(spin_event_ms(torch, lambda: epilogue.rank_epilogue_plain(
                g_n, g_a, *svs, sp, all_methods=True), reps), 6),
            "library_ms": round(spin_event_ms(
                torch, lambda: torch.sort(neg, dim=-1, stable=True), reps), 6),
            "bound_ms": round(max(bytes_ms, ops_ms), 6),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
        }
    out["sweep"] = selection_sweep(torch, g_n, g_a, svs, cfg, v, min(reps, 50))
    # The whole program: one all-methods program against 13 one-formula
    # programs (what a harness without K13 would run), in turns, by
    # events behind a ~100 ms spin, k = V.
    sp = dataclasses.replace(cfg.spectrum, top_max=v)
    sides = {
        "all_methods": lambda: tc._rank_program(dgraph, pr, sp, kernel, "all_methods"),
        "thirteen_programs": lambda: [tc._rank_program(
            dgraph, pr, dataclasses.replace(sp, method=m), kernel) for m in METHODS],
    }
    turns = {key: [] for key in sides}
    for key in ("all_methods", "thirteen_programs", "thirteen_programs", "all_methods"):
        turns[key].append(spin_event_ms(torch, sides[key], 5, PROGRAM_SPIN_CYCLES))
    out["program_turns_ms"] = {key: [round(x, 6) for x in val] for key, val in turns.items()}
    return out


def tiny_scan_checks(torch, dev):
    """First calls of K10 (``csr_scan_spmv``): groups of CSR matrices at
    every depth of block totals (up to 2048 entries: one tile; past it,
    a top scan of the tile totals; 2048^2 + 1: two levels, which only the
    first design takes), empty rows and matrices, one window and three,
    through scan_step (one launch) and the level passes, each bitwise
    their plain version on the CPU. Returns the number of cases."""
    import numpy as np

    from microrank_tpu_torch.ops import scan

    cases = 0
    for sizes, windows in ((((5, 17, 9),), None), (((40, 2048, 50), (3, 0, 7)), 3),
                           (((300, 5000, 400), (10, 30, 11)), None),
                           (((2000, 2048 ** 2 + 1, 3000), (50, 900, 60)), None)):
        gen = np.random.default_rng(cases)
        b = windows or 1
        mats, n_x = [], []
        for rows, e, nx in sizes:
            lens = np.minimum(np.cumsum(gen.integers(0, 2 * e // max(rows, 1) + 1,
                                                     size=(b, rows)), 1), e)
            ip = np.concatenate([np.zeros((b, 1), np.int64), lens], 1).astype(np.int32)
            cols = gen.integers(0, nx, size=(b, e)).astype(np.int32)
            vals = gen.random((b, e)).astype(np.float32)
            sq = (lambda a: a[0]) if windows is None else (lambda a: a)
            mats.append(tuple(torch.from_numpy(sq(a)) for a in (ip, cols, vals)))
            n_x.append(nx)
        lead = () if windows is None else (windows,)
        xs = [torch.from_numpy(gen.random(lead + (nx,)).astype(np.float32)) for nx in n_x]
        slots = tuple(range(len(sizes)))
        cpu = scan.scan_group(mats, slots, n_x, windows)
        card = scan.scan_group([tuple(t.to(dev) for t in m) for m in mats], slots, n_x, windows,
                               levels=True)
        want = scan.csr_scan_spmv(cpu, xs)
        designs = ("step", "levels") if card.plan is not None else ("levels",)
        check(card.plan is not None or max(card.e_pad) > scan.BLOCK ** 2,
              f"tiny K10 case {cases}: scan_step did not take the group")
        for design in designs:
            before = scan.csr_scan_spmv.by_design[design]
            got = scan.csr_scan_spmv(card, [x.to(dev) for x in xs], design=design)
            torch.cuda.synchronize()
            check(scan.csr_scan_spmv.by_design[design] == before + 1,
                  f"tiny K10 case {cases}: no {design} launch counted")
            for g, w in zip(got, want):
                check(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)),
                      f"tiny K10 case {cases} ({design}) differs from its plain version")
        cases += 1
    return cases


def measure_csr_scan(torch, spmv, name, dgraph):
    """K10 at a staged csr window's shapes (``dgraph.spmv_group``, the
    six matrices of a step): scan_step (one launch a step) bitwise its
    plain version on the CPU, the level passes and over 50 calls; timed by
    CUDA events behind a spin in turns with the level passes (the design
    it replaces) and K1 over the csr work list (K1's design, not JAX's
    order of sums), beside the plain version on the card, six CSR
    matvecs of the same views (the library yardstick) and the byte bound
    (each matrix's indptr, live cols and vals, x read once, y written
    once; 2 flops an entry)."""
    from microrank_tpu_torch.ops import scan
    from microrank_tpu_torch.rank_backends.torch_cuda import csr_layouts, window_spmv_group

    dev = torch.device("cuda")
    group = dgraph.spmv_group
    check(isinstance(group, scan.ScanGroup), f"{name}: the csr route built no scan group")
    check(group.plan is not None, f"{name}: scan_step did not take the csr window")
    # The level passes over the same matrices (their scratch: a scan pair an
    # entry).
    levels = scan.scan_group(
        [(ip.to(torch.int32), c, v)
         for ip, c, v in zip(group.indptr, *_scan_matrix_entries(torch, group))],
        group.x_slots, group.n_x, group.windows, checked=True, levels=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    v = int(dgraph.normal.cov_unique.shape[0])
    sizes = (int(dgraph.normal.kind.shape[0]), v, int(dgraph.abnormal.kind.shape[0]), v)
    xs = [torch.rand(k, generator=gen, device=dev) for k in sizes]
    before = scan.csr_scan_spmv.launches
    ys = scan.csr_scan_spmv(group, xs)
    torch.cuda.synchronize()
    check(scan.csr_scan_spmv.launches == before + 1 and scan.csr_scan_spmv.by_design["step"],
          f"{name}: scan_step did not launch once")
    prior = scan.csr_scan_spmv(levels, xs, design="levels")
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(ys, prior)),
          f"{name}: scan_step differs from the level passes")
    cpu_group = group._replace(**{f: (tuple(t.cpu() for t in getattr(group, f))
                                      if f == "indptr" else getattr(group, f).cpu())
                                  for f in ("cols", "vals", "indptr")})
    ref = scan.csr_scan_spmv_plain(cpu_group, [x.cpu() for x in xs])
    bitwise = all(torch.equal(y.cpu().view(torch.int32), r.view(torch.int32))
                  for y, r in zip(ys, ref))
    check(bitwise, f"{name}: K10 differs from its plain version on the CPU")
    first = torch.cat(ys)
    again = [torch.cat(scan.csr_scan_spmv(group, xs)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, first) for a in again),
          f"{name}: K10 is not bitwise repeatable over {REPEATS} calls")
    layouts = [*csr_layouts(dgraph.normal), *csr_layouts(dgraph.abnormal)]
    previous = window_spmv_group(dgraph, csr_layouts)
    mx = [xs[s] for s in group.x_slots]
    csrs = [csr_of(torch, lay, int(x.shape[0])) for lay, x in zip(layouts, mx)]
    calls = {
        "kernel": lambda: scan.csr_scan_spmv(group, xs),
        "levels_design": lambda: scan.csr_scan_spmv(levels, xs, design="levels"),
        "previous_design": lambda: spmv.coo_spmv_group(previous, xs),
        "plain": lambda: scan.csr_scan_spmv_plain(group, xs),
        "library": lambda: [torch.mv(c, x) for c, x in zip(csrs, mx)],
    }
    order = ("levels_design", "previous_design", "kernel", "kernel", "previous_design",
             "levels_design")
    turns = [(k, spin_event_ms(torch, calls[k], 20)) for k in order]
    ms = {k: _mean([t for kk, t in turns if kk == k])
          for k in ("kernel", "levels_design", "previous_design")}
    # Where scan_step's time goes: the global time between its phases
    # (the latest block's end of each; the median of 9 calls, ms).
    stamps = torch.zeros(scan.STEP_STAMPS, dtype=torch.int64, device=dev)
    splits = []
    for _ in range(9):
        stamps.zero_()
        scan.csr_scan_spmv(group, xs, stamps=stamps)
        c = stamps.tolist()
        splits.append([(c[i + 1] - c[i]) / 1e6 for i in range(scan.STEP_STAMPS - 1)])
    phase_ms = {k: round(_median([row[i] for row in splits]), 6)
                for i, k in enumerate(SCAN_PHASES)}
    ms["library"] = spin_event_ms(torch, calls["library"], 20)
    ms["plain"] = spin_event_ms(torch, calls["plain"], 3)
    total_bytes, bytes_ms, ops_ms = 0, 0.0, 0.0
    for lay, x in zip(layouts, mx):
        b, b_ms, o_ms = spmv_bound(lay.n_rows, int(lay.indptr[-1]), int(x.shape[0]))
        total_bytes, bytes_ms, ops_ms = total_bytes + b, bytes_ms + b_ms, ops_ms + o_ms
    return {
        "name": name,
        "entries": [int(lay.indptr[-1]) for lay in layouts],
        "launches_a_call": 1,
        "plan": group.plan._asdict(),
        "phase_ms": phase_ms,
        "tiles": int(group.tiles.shape[0]),
        "levels_design_launches_a_call": 2 * (len(levels.blocks) - 1) + 2,
        "ms": round(ms["kernel"], 6),
        "levels_design_ms": round(ms["levels_design"], 6),
        "previous_design_ms": round(ms["previous_design"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": total_bytes,
        "max_abs_err": 0.0,
        "bitwise_vs_cpu_plain": bitwise,
        "bitwise_repeatable_calls": REPEATS,
    }


def _scan_matrix_entries(torch, group):
    """A scan group's cols and vals split back into its matrices
    ([B, E] each for a stacked group, [E] for one window)."""
    b = group.windows or 1
    sizes = [b * e for e in group.e_pad]
    cols = group.cols.split(sizes)
    vals = group.vals.split(sizes)
    if group.windows is None:
        return cols, vals
    return ([c.view(b, -1) for c in cols], [v.view(b, -1) for v in vals])


def measure_k19(torch, name, dgraph, cfg, kernel, reps):
    """K19 at a staged window's set-up shapes, with an init mapped from
    the window itself (its own warm program's state tail, cold): the
    set-up's warm instance bitwise its plain version (the cold plain
    set-up, then ``warm_override_plain``) and over 50 launches; an
    all-miss init bitwise the cold set-up; timed by CUDA events behind a
    spin in turns with the cold set-up (cold, warm, warm, cold), beside
    the plain version on the card and the byte bound (the cold set-up's
    bytes and the four init vectors read once)."""
    from microrank_tpu_torch.ops import setup
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    pr = cfg.pagerank
    g_n, g_a = dgraph.normal, dgraph.abnormal
    tail = tc.rank_window_warm_core(dgraph, None, pr, cfg.spectrum, kernel)[5:9]
    init = tuple(t.contiguous() for t in tail)
    plan = setup._plan(int(g_n.kind.shape[-1]), int(g_a.kind.shape[-1]), 1,
                       int(g_n.op_present.shape[-1]), g_n.kind.device.index, False)
    warm = setup_bits(torch, setup.rank_setup(g_n, g_a, pr, init=init))
    plain = setup_bits(torch, setup.rank_setup_plain(g_n, g_a, pr, init))
    check(torch.equal(warm, plain), f"{name}: K19's set-up differs from its plain version")
    cold = setup_bits(torch, setup.rank_setup(g_n, g_a, pr))
    check(not torch.equal(warm, cold), f"{name}: the window's own init started cold")
    for _ in range(REPEATS):
        check(torch.equal(setup_bits(torch, setup.rank_setup(g_n, g_a, pr, init=init)), warm),
              f"{name}: K19's set-up is not repeatable")
    misses = tuple(torch.zeros_like(t) for t in init)
    check(torch.equal(setup_bits(torch, setup.rank_setup(g_n, g_a, pr, init=misses)), cold),
          f"{name}: an all-miss init is not the cold set-up")
    calls = {"warm": lambda: setup.rank_setup(g_n, g_a, pr, init=init),
             "cold": lambda: setup.rank_setup(g_n, g_a, pr)}
    turns = [(k, spin_event_ms(torch, calls[k], reps)) for k in ("cold", "warm", "warm", "cold")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in calls}
    plain_ms = spin_event_ms(torch, lambda: setup.rank_setup_plain(g_n, g_a, pr, init), 3)
    nbytes, flops = setup_bound(torch, dgraph)
    nbytes += 4 * sum(int(t.numel()) for t in init)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {
        "name": name, "form": plan.form, "cluster": plan.cluster,
        "bitwise_vs_plain": True, "all_miss_bitwise_cold": True,
        "bitwise_repeatable_launches": REPEATS,
        "ms": round(ms["warm"], 6), "cold_ms": round(ms["cold"], 6),
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "plain_ms": round(plain_ms, 6),
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "max_abs_err": 0.0, "library_ms": None,
    }


# K15 (the attribution epilogue, ops/explain.py) alone at the config-5
# windows of every route: label -> (run key of its host graph, kernel).
# packed_blocked and pcsr are the runs at the lowered budgets (64 MiB,
# 16 MiB); the sparse families' graphs are the families phase's.
K15_ROUTES = {
    "kind": ("auto/auto", "kind"),
    "packed_bf16": ("auto/off", "packed_bf16"),
    "packed_blocked": ("auto/packed_blocked", "packed_blocked"),
    "pcsr": ("auto/pcsr", "pcsr"),
    "pallas": ("pallas/off", "pallas"),
    "coo": ("families/coo/off", "coo"),
    "csr": ("families/csr/off", "csr"),
    "dense": ("families/dense/auto", "dense"),
    "dense_bf16": ("families/dense_bf16/auto", "dense_bf16"),
}


def explained_bits(torch, out):
    """K15's five outputs' bits, one int32 vector."""
    return torch.cat([t.reshape(-1).view(torch.int32) for t in out])


def k15_bytes(torch, dgraph, kernel, top_idx, ke, j):
    """K15's bytes for the function it computes on this window's data:
    per partition, rv and each per-column vector its route reads (4
    bytes a column), and of the staged view what the suspects need: their
    bitmap rows, the ELL slab's ops (4 bytes a cell) and its rs where
    the op is a suspect (4 bytes each), their op-major
    ranges (column and value, 8 bytes an entry, and rv at the column),
    or every live trace-major entry's op and column (8 bytes) and the
    suspects' values and rv; the counters' inputs at the suspects; the
    outputs written once."""
    from microrank_tpu_torch.ops import explain as kx

    route = kx.ROUTES[kernel]
    sus = top_idx[:ke].long()
    total = 0
    for g in (dgraph.normal, dgraph.abnormal):
        t = int(g.kind.shape[0])
        if route == kx.BITMAP:
            total += 8 * t + ke * int(g.cov_bits.shape[1])
        elif route == kx.ELL:
            named = int(torch.isin(g.pc_ell_op, sus.to(g.pc_ell_op.dtype)).sum())
            total += 12 * t + 4 * int(g.pc_ell_op.numel()) + 4 * named
        elif route == kx.OP_MAJOR:
            ptr = g.inc_indptr_op.long()
            total += 8 * ke + 12 * int((ptr[sus + 1] - ptr[sus]).sum())
        else:
            n_inc = int(g.n_inc)
            mine = int(torch.isin(g.inc_op[:n_inc].long(), sus).sum())
            total += 8 * n_inc + 8 * mine
    total += ke * (4 + 4 + 1 + 1 + 4 + 4) + 4 * (4 + 13 + 2) * ke + 2 * ke * j * 8
    return total


def measure_k15(torch, name, dgraph, cfg, kernel, reps):
    """K15 at a staged window, on its rank program's final rv and
    epilogue (``ExplainConfig`` defaults: Ke = n_rows, J = 5): bitwise
    its plain version on the card and over 50 launches; timed by CUDA
    events behind a spin in turns with the plain version and the
    yardstick, the selection alone: one stable ``torch.sort`` of the
    [2, Ke, T] contribution rows (the plain version's, -inf past the
    live columns, the smaller partition padded with -inf), negated;
    beside the byte bound at 3.35 TB/s (``k15_bytes``) and the plan."""
    from microrank_tpu_torch.config import ExplainConfig
    from microrank_tpu_torch.ops import explain as kx
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    program = tc._rank_program(dgraph, cfg.pagerank, cfg.spectrum, kernel)
    epi = program.epilogue
    ex = ExplainConfig(enabled=True)
    g_n, g_a = dgraph.normal, dgraph.abnormal
    args = (g_n, g_a, program.rv_n, program.rv_a, epi, cfg.spectrum, ex, kernel)
    got = explained_bits(torch, kx.explain_epilogue(*args))
    check(torch.equal(got, explained_bits(torch, kx.explain_plain(*args))),
          f"{name}: K15 differs from its plain version")
    for _ in range(REPEATS):
        check(torch.equal(explained_bits(torch, kx.explain_epilogue(*args)), got),
              f"{name}: K15 is not repeatable")
    ke = kx.n_suspects(int(epi.top_idx.shape[0]), ex)
    sus = epi.top_idx[:ke].long()
    t_n, t_a = int(g_n.kind.shape[0]), int(g_a.kind.shape[0])
    rows = []
    for g, rv in ((g_n, program.rv_n), (g_a, program.rv_a)):
        c = kx.contrib_rows(g, sus, rv, kernel)
        live = torch.arange(c.shape[1], device=c.device) < torch.where(g.n_cols < 0, g.n_traces,
                                                                         g.n_cols)
        c = torch.where(live[None, :], c, float("-inf"))
        rows.append(torch.nn.functional.pad(c, (0, max(t_n, t_a) - c.shape[1]),
                                            value=float("-inf")))
    neg = -(torch.stack(rows) + 0.0)
    calls = {"k15": lambda: kx.explain_epilogue(*args),
             "plain": lambda: kx.explain_plain(*args),
             "sort": lambda: torch.sort(neg, dim=-1, stable=True)}
    turns = [(k, spin_event_ms(torch, calls[k], reps))
             for k in ("k15", "plain", "sort", "sort", "plain", "k15")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in calls}
    plan = kx.window_plan(g_n, g_a, kernel, ex.top_traces, ke)
    nbytes = k15_bytes(torch, dgraph, kernel, epi.top_idx, ke, ex.top_traces)
    return {
        "name": name, "kernel": kernel, "route": ("bitmap", "ell", "op_major",
                                                  "trace_major")[kx.ROUTES[kernel]],
        "columns": [t_n, t_a], "suspects": ke, "top_traces": ex.top_traces,
        "plan": {**plan._asdict(), "kernel_launches": plan.kernel_launches,
                 "fill_blocks": plan.fill_blocks},
        "bitwise_vs_plain": True, "bitwise_repeatable_launches": REPEATS,
        "ms": round(ms["k15"], 6), "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["sort"], 6),
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6), "bound_by": "bytes",
        "bytes": nbytes, "max_abs_err": 0.0,
    }


def tiny_k15_checks(torch, dev):
    """K15's first launches: a small window (40,000 spans, 192 ops, some
    5,000 columns a partition: a fill of several units and a merge) on
    every route, J = 5 (the warp-select) and 40 (the bitonic path),
    bitwise its plain version on the card; then a collapsed trace-major
    window (coo and dense: chunks of a few dozen entries inside long kind
    runs) and Ke 46 past the 32-suspect match word (top_max 40,
    top_suspects 0) on a route of each fill."""
    from microrank_tpu_torch.config import ExplainConfig, PageRankConfig, SpectrumConfig
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.ops import explain as kx
    from microrank_tpu_torch.rank_backends import torch_cuda as tc
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.testing import giant_window

    gw = giant_window(n_spans=40_000, n_ops=192, seed=5)
    aux = {"kind": "kind", "packed": "packed", "packed_bf16": "packed",
           "packed_blocked": "packed", "pcsr": "pcsr", "csr": "csr", "coo": "none",
           "pallas": "none", "dense": "none", "dense_bf16": "none"}
    built, n = {}, 0
    wide = SpectrumConfig(top_max=40)
    cases = [(kernel, "on" if kernel == "kind" else "off", SpectrumConfig(), j)
             for kernel in aux for j in (5, 40)]
    cases += [(kernel, "on", SpectrumConfig(), j) for kernel in ("coo", "dense") for j in (5, 40)]
    cases += [(kernel, "on" if kernel == "kind" else "off", wide, 5)
              for kernel in ("kind", "pcsr", "csr", "coo")]
    for kernel, collapse, spectrum, j in cases:
        view = aux[kernel]
        if (view, collapse) not in built:
            built[view, collapse] = build_window_graph_from_table(
                gw.table, None, gw.normal_codes, gw.abnormal_codes, aux=view,
                collapse=collapse)[0]
        dg = tc.device_subset(graph_from_numpy(tc.host_subset(built[view, collapse], kernel),
                                               dev), kernel)
        prog = tc._rank_program(dg, PageRankConfig(), spectrum, kernel)
        args = (dg.normal, dg.abnormal, prog.rv_n, prog.rv_a, prog.epilogue, spectrum,
                ExplainConfig(enabled=True, top_traces=j), kernel)
        got = kx.explain_epilogue(*args)
        check(spectrum is not wide or got.counters.shape[1] > kx.SUS,
              f"tiny K15 ({kernel}): Ke {got.counters.shape[1]} is not past {kx.SUS}")
        want = kx.explain_plain(*args)
        check(torch.equal(explained_bits(torch, got), explained_bits(torch, want)),
              f"tiny K15 ({kernel}, collapse {collapse}, J {j}, Ke {got.counters.shape[1]}) "
              "differs from its plain version")
        n += 1
    return n


def bundle_vs_oracle(bundle, oracle, rtol):
    """An incident's bundle against the float64 oracle: the top-5
    tie-aware at ``rtol``; then, suspect by suspect (matched by op; an op
    at the cut may be a near-tie's), the counters and the mass within
    ``rtol``, each top trace's contribution within ``rtol`` of the
    oracle's for that trace, and every oracle contributor above the cut
    (past tie tolerance) kept. Returns (ok, why)."""
    import numpy as np

    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    dev, orc = bundle.suspects, oracle["suspects"]
    ok, why = tie_aware_topk_agreement([s["op"] for s in dev], [s["score"] for s in dev],
                                       [s["op"] for s in orc], [s["score"] for s in orc],
                                       k=5, rtol=rtol)
    if not ok:
        return False, f"top-5: {why}"
    by_op = {s["op"]: s for s in orc}
    for s in dev[:5]:
        o = by_op.get(s["op"])
        if o is None:
            continue
        for key, names in (("counters", ("ef", "nf", "ep", "np")),
                           ("mass", ("normal_weight", "abnormal_weight"))):
            for c in names:
                if not np.isclose(s[key][c], o[key][c], rtol=rtol, atol=1e-12):
                    return False, f"{s['op']} {c}: {s[key][c]} vs {o[key][c]}"
        for p in ("normal", "abnormal"):
            omap = dict(o["top_traces"][p])
            entries = s["top_traces"][p]
            for e in entries:
                if e.get("trace") not in omap or not np.isclose(
                        e["contribution"], omap[e["trace"]], rtol=rtol):
                    return False, f"{s['op']} {p} trace {e}"
            if entries:
                cut = min(e["contribution"] for e in entries)
                beat = {t for t, v in omap.items() if v > cut * (1 + rtol)}
                if not beat <= {e["trace"] for e in entries}:
                    return False, f"{s['op']} {p}: {beat} not all kept"
    return True, "ok"


def phase_explain(torch, spmv, pattern, graphs, giant_k15, src, workdir):
    """Rank provenance (K15) at config 5 (see the module note): K15 alone
    on every route's window (and the giant windows', measured in the
    giant phase), the explained program in turns with the one-formula
    program at the kind window, then the stream phase's timeline, tumbling,
    with ``ExplainConfig.enabled``, counted, its incident's bundle, flight
    dump, journal record, ``/explainz``, ``cli explain`` and the float64
    oracle gated. Returns (launch counts, the phase's line)."""
    import urllib.parse
    import urllib.request

    import numpy as np

    from microrank_tpu_torch.config import (
        DispatchConfig,
        ExplainConfig,
        MicroRankConfig,
        StreamConfig,
    )
    from microrank_tpu_torch.explain.bundle import BUNDLE_JSON, ExplainBundle
    from microrank_tpu_torch.explain.oracle import explain_window_oracle
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.obs import read_journal
    from microrank_tpu_torch.obs.server import start_metrics_server
    from microrank_tpu_torch.obs.spans import get_tracer
    from microrank_tpu_torch.ops import explain as kx
    from microrank_tpu_torch.rank_backends import torch_cuda as tc
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.stream import StreamEngine

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = MicroRankConfig()
    ex = ExplainConfig(enabled=True)
    out = {"phase": "explain", "k15": {}}
    for label, (key, kernel) in K15_ROUTES.items():
        dg = tc.device_subset(graph_from_numpy(tc.host_subset(graphs[key], kernel), dev), kernel)
        out["k15"][label] = measure_k15(torch, f"explain/{label}", dg, cfg, kernel, K6_REPS)
        if label == "kind":
            # What explain costs at incident open: the explained program
            # in turns with the one-formula program, events behind a
            # ~100 ms spin.
            sides = {"one_formula": lambda: tc._rank_program(dg, cfg.pagerank, cfg.spectrum,
                                                             kernel),
                     "explained": lambda: tc._rank_program(dg, cfg.pagerank, cfg.spectrum,
                                                           kernel, "explained",
                                                           explain_cfg=ex)}
            turns = [(k, spin_event_ms(torch, sides[k], 5, PROGRAM_SPIN_CYCLES))
                     for k in ("one_formula", "explained", "explained", "one_formula")]
            out["program_ms"] = {"kernel": kernel,
                                 **{k: round(_mean([t for kk, t in turns if kk == k]), 6)
                                    for k in sides},
                                 "turns_ms": [[k, round(t, 6)] for k, t in turns]}
        del dg
    for want, k15 in giant_k15.items():
        out["k15"][f"giant_{want}"] = k15
    torch.cuda.empty_cache()

    # The stream timeline with explain on: the main path, counted.
    run_dir = workdir / "stream_explain"
    scfg = MicroRankConfig(stream=StreamConfig(allowed_lateness_seconds=0.0, pipeline_windows=3),
                           explain=ex, dispatch=DispatchConfig(warmup_manifest=False))
    engine = StreamEngine(scfg, src, out_dir=run_dir, device="cuda")
    builds, prepare = {}, engine._prepare

    def recorded(table, mask, nrm, abn, rng):
        built = prepare(table, mask, nrm, abn, rng)
        builds[int(table.start_us.min())] = ((table, mask, nrm, abn, rng), built)
        return built

    engine._prepare = recorded
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    t1 = time.perf_counter()
    s = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts(spmv, pattern)
    ranked = [r for r in s.results if r.ranking]
    check(s.incidents_opened == 1 and ranked, f"explain/stream: {s.incidents_opened} incidents "
                                              f"opened, {len(ranked)} windows ranked")
    bundle_dirs = list((run_dir / "explain").iterdir())
    check(len(bundle_dirs) == 1, f"explain/stream: {len(bundle_dirs)} bundles written")
    bundle = ExplainBundle.load(bundle_dirs[0] / BUNDLE_JSON)
    kernel = bundle.data["kernel"]
    # The window that opened the incident, as the engine built it.
    w0 = int(np.datetime64(str(bundle.window["start"]).replace(" ", "T"), "us").astype(np.int64))
    (table, mask, nrm, abn, rng), built = builds[min(k for k in builds if k >= w0)]
    g_n = built[0].normal
    plan = kx.window_plan(g_n, built[0].abnormal, kernel, ex.top_traces, kx.n_suspects(
        min(scfg.spectrum.n_rows, int(g_n.cov_unique.shape[0])), ex))
    groups = [r.batch_windows or 1 for r in ranked]
    expect = expected_counts(kernel, len(ranked) + 1, programs=s.dispatches + 1,
                             groups=round(sum(1 / b for b in groups if b > 1)),
                             explained=(1, plan.kernel_launches))
    check(counts == expect, f"explain/stream: launch counts {counts}, want {expect}")
    # The incident's flight dump holds the bundle and links it.
    dumps = [d for d in (run_dir / "flight").iterdir() if d.name.endswith("-incident")]
    check(len(dumps) == 1 and (dumps[0] / BUNDLE_JSON).exists(),
          f"explain/stream: flight dumps {dumps} (one holding the bundle wanted)")
    manifest = json.loads((dumps[0] / "manifest.json").read_text())
    check(manifest.get("explain_bundle") == BUNDLE_JSON,
          f"explain/stream: the dump's manifest does not link the bundle: {manifest}")
    # The journal's record: the ranked window's top-1 and ef.
    events = read_journal(run_dir / "journal.jsonl")
    rec = [e for e in events if e["event"] == "explain"]
    first = next(e for e in events if e["event"] == "window" and e.get("outcome") == "ranked")
    check(len(rec) == 1 and rec[0]["top1"] == first["top1"] == bundle.top1()
          and rec[0]["ef_top1"] == bundle.suspects[0]["counters"]["ef"]
          and rec[0]["start"] == first["start"],
          f"explain/stream: the journal's explain record {rec} vs the ranked window {first}")
    fault = src.fault_pod_op
    check(fault in [x["op"] for x in bundle.suspects[:5]],
          f"explain/stream: the fault {fault} is not among the bundle's first 5 suspects")
    # /explainz on a metrics server serves the bundle.
    server = start_metrics_server(0)
    try:
        url = (f"http://127.0.0.1:{server.port}/explainz?window="
               f"{urllib.parse.quote(str(bundle.window['start']))}")
        with urllib.request.urlopen(url, timeout=30) as r:
            served = json.loads(r.read())
    finally:
        server.close()
    check(served == bundle.data, "explain/stream: /explainz does not serve the written bundle")
    # cli explain renders it.
    cli = subprocess.run([sys.executable, "-m", "microrank_tpu_torch.cli", "explain",
                          str(run_dir)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(cli.returncode == 0 and bundle.top1() in cli.stdout,
          f"explain/stream: cli explain exited {cli.returncode}: {cli.stderr[-500:]}")
    # The float64 oracle of the window, uncollapsed (summed per kind
    # where the stream's build collapsed it).
    g_un, names, codes_n, codes_a = build_window_graph_from_table(
        table, mask, nrm, abn, aux="none", collapse="off", row_range=rng)
    ids = table.trace_names
    t2 = time.perf_counter()
    oracle = explain_window_oracle(g_un, names, [ids[int(c)] for c in codes_n],
                                   [ids[int(c)] for c in codes_a], cfg.pagerank, cfg.spectrum,
                                   aggregate_kinds=int(built[0].normal.n_cols) >= 0)
    oracle_s = time.perf_counter() - t2
    ok, why = bundle_vs_oracle(bundle, oracle, ORACLE_RTOL)
    check(ok, f"explain/stream: the bundle against the float64 oracle: {why}")
    out["stream"] = {
        "windows": s.windows, "ranked": s.ranked, "dispatches": s.dispatches,
        "incidents": [s.incidents_opened, s.incidents_resolved], "kernel": kernel,
        "launches": counts, "explain_plan": plan._asdict(),
        "bundle": {"window": bundle.window, "suspects": len(bundle.suspects),
                   "top1": bundle.top1(), "fault_rank": 1 + [x["op"] for x in
                                                             bundle.suspects].index(fault),
                   "iterations": bundle.data["iterations"]},
        "flight_dump_links_bundle": True, "journal_record": rec[0]["top1"],
        "explainz_serves_bundle": True, "cli_explain_names_top1": True,
        "oracle_rtol": ORACLE_RTOL, "oracle_tie_aware_top5_counters_mass_traces": True,
        "oracle_s": round(oracle_s, 3),
        # The explain span at incident open (stage, program, fetch,
        # bundle), host clock.
        "explain_span_ms": round(next((sp.dur_us for sp in get_tracer().snapshot()
                                       if sp.name == "explain"), 0) / 1e3, 3),
        "ranked_window_ms": [r.timings.get("rank_ms") for r in ranked],
        "wall_s": round(wall, 3),
    }
    out["nvidia_smi"] = power_line()
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    return {"explain/stream": counts}, out


STREAM_FAULTS = (3, 4, 5)
STREAM_WINDOWS = 8
# The stream phase's default-mode run (its counts and rankings), which
# the serve phase's co-deploy is held to.
STREAM_SOLO: dict = {}
# The stream phase's runs: (stream config, runtime, pagerank).
STREAM_MODES = {
    "default": (dict(pipeline_windows=3), {}, {}),
    "warm_start": (dict(slide_minutes=2.5), dict(warm_start=True), dict(tol=1e-4, iterations=50)),
    "fused_pair": (dict(slide_minutes=2.5), dict(fused_pair=True), dict(tol=1e-4, iterations=50)),
    "cold_sliding": (dict(slide_minutes=2.5), {}, dict(tol=1e-4, iterations=50)),
}
WARM_RTOL = 1e-3  # warm vs cold: both stop within tol 1e-4 of the fixed point


def stream_run(torch, spmv, pattern, source, mode, manifest=None, timed=None):
    """One ``StreamEngine`` run of ``source`` in ``mode`` on the card,
    counted; the engine's host builds recorded by window start, and each
    mapped warm init's nonzero entries against its length (sv_n, rv_n,
    sv_a, rv_a: what carried across the slide). ``manifest``: the warmup
    manifest's directory (its restart replays what an earlier run there
    recorded; the counts then hold the replay's launches too), else
    none. ``timed``: a dict that gets the warm start's seconds. Returns
    (summary, launch counts, builds, wall s, config, the inits' hits)."""
    import dataclasses

    from microrank_tpu_torch.rank_backends import warm

    from microrank_tpu_torch.config import (
        DispatchConfig,
        MicroRankConfig,
        PageRankConfig,
        RuntimeConfig,
        StreamConfig,
    )
    from microrank_tpu_torch.stream import StreamEngine

    sc, rt, pr = STREAM_MODES[mode]
    # Without a manifest no warm restart: the run launches its own
    # windows only.
    cfg = MicroRankConfig(
        stream=StreamConfig(allowed_lateness_seconds=0.0, **sc),
        runtime=dataclasses.replace(RuntimeConfig(), **rt), pagerank=PageRankConfig(**pr),
        dispatch=DispatchConfig(warmup_manifest=manifest is not None))
    engine = StreamEngine(cfg, source, device="cuda")
    builds, prepare = {}, engine._prepare
    if timed is not None:
        warm_start = engine._warm_start

        def timed_warm_start():
            t = time.perf_counter()
            warm_start()
            timed["warm_start_s"] = round(time.perf_counter() - t, 3)

        engine._warm_start = timed_warm_start

    def recorded(table, mask, nrm, abn, rng):
        out = prepare(table, mask, nrm, abn, rng)
        builds[int(table.start_us.min())] = out  # a window's first span
        return out

    engine._prepare = recorded
    hits, map_state = [], warm.map_warm_state

    def mapped(prev, op_names, ectx, graph):
        init = map_state(prev, op_names, ectx, graph)
        if init is not None:
            hits.append([[int((x != 0).sum()), int(x.shape[0])] for x in init])
        return init

    warm.map_warm_state = mapped
    cache_env = os.environ.get("MICRORANK_JIT_CACHE")
    if manifest is not None:
        os.environ["MICRORANK_JIT_CACHE"] = str(manifest)
    try:
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        summary = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        warm.map_warm_state = map_state
        if cache_env is not None:
            os.environ["MICRORANK_JIT_CACHE"] = cache_env
    return summary, read_counts(spmv, pattern), builds, wall, cfg, hits


def stream_source(args):
    """The stream phases' config-5 timeline: STREAM_WINDOWS windows of
    about --spans spans, faults in STREAM_FAULTS (a source iterates it
    again for every run). Returns (source, seconds to generate)."""
    from microrank_tpu_torch.stream import SyntheticSource
    from microrank_tpu_torch.testing import SyntheticConfig

    t0 = time.perf_counter()
    src = SyntheticSource(
        STREAM_WINDOWS, list(STREAM_FAULTS),
        SyntheticConfig(n_operations=args.ops, n_kinds=max(32, args.ops // 50),
                        child_keep_prob=0.55, fault_latency_ms=60000.0, seed=0),
        chunk_spans=200_000, spans_per_window=args.spans)
    return src, time.perf_counter() - t0


def phase_stream(torch, spmv, pattern, args, src, gen_s, workdir):
    """The stream lane at config-5 scale (see the module note) over
    ``src`` (``stream_source``); returns (launch counts by run, the
    phase's line)."""
    import numpy as np

    from microrank_tpu_torch.dispatch import DispatchRouter, bucket_key, manifest_shapes
    from microrank_tpu_torch.obs import get_registry
    from microrank_tpu_torch.rank_backends import torch_cuda as tc
    from microrank_tpu_torch.stream.window import stamp
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    def us(text):
        return int(np.datetime64(text.replace(" ", "T"), "us").astype(np.int64))

    def build_of(builds, start):
        # The window's build: the one whose first span is nearest its
        # start (a sliding window's successor starts a slide later).
        w0 = us(start)
        return builds[min(k for k in builds if k >= w0)]

    window_us = int(src.timeline.window_minutes * 60e6)
    t_start = int(src.timeline.start.astype(np.int64))
    faulted = [(t_start + k * window_us, t_start + (k + 1) * window_us) for k in STREAM_FAULTS]
    launches, out, runs = {}, {"phase": "stream", "generate_s": round(gen_s, 3),
                               "timeline_spans": src.table.n_spans, "windows": STREAM_WINDOWS,
                               "fault_windows": list(STREAM_FAULTS),
                               "fault_pod_op": src.fault_pod_op}, {}
    # The default run records its occupancies and shapes in a manifest of
    # its own, which the warm restart below replays.
    stream_jit = workdir / "stream_jit"
    for mode in STREAM_MODES:
        tag = f"stream/{mode}"
        s, counts, builds, wall, cfg, hits = stream_run(
            torch, spmv, pattern, src, mode, manifest=stream_jit if mode == "default" else None)
        runs[mode] = (s, builds, cfg)
        launches[tag] = counts
        ranked = [r for r in s.results if r.ranking]
        sliding = mode != "default"
        check(s.windows >= STREAM_WINDOWS + (STREAM_WINDOWS - 1 if sliding else 0),
              f"{tag}: {s.windows} windows closed")
        # Only abnormal windows ranked: every ranked window overlaps a
        # faulted one, and every faulted window is ranked.
        starts = {r.start for r in ranked}
        for r in ranked:
            w0 = us(r.start)
            check(any(w0 < e and w0 + window_us > b for b, e in faulted),
                  f"{tag}: window {r.start} ranked, no fault in it")
            check(r.ranking[0][0] == src.fault_pod_op,
                  f"{tag}: window {r.start} top-1 {r.ranking[0][0]}")
        check(all(stamp(b) in starts for b, _ in faulted),
              f"{tag}: a faulted window was not ranked ({sorted(starts)})")
        check(s.incidents_opened == 1 and s.incidents_resolved == 1,
              f"{tag}: incidents {s.incidents_opened} opened, {s.incidents_resolved} resolved")
        groups = [r.batch_windows or 1 for r in ranked]
        warm = sum(r.route in ("warm", "fused") for r in ranked)
        expect = expected_counts(ranked[0].kernel, len(ranked), programs=s.dispatches,
                                 groups=round(sum(1 / b for b in groups if b > 1)), warm=warm,
                                 steps=cfg.pagerank.iterations)
        check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")
        stages = {k: round(_mean([r.timings.get(k, 0.0) for r in ranked]), 3)
                  for k in ("admit", "detect", "build", "rank_ms")}
        all_stages = {k: round(_mean([r.timings[k] for r in s.results if k in r.timings]), 3)
                      for k in ("admit", "detect")}
        out[mode] = {
            "windows": s.windows, "ranked": s.ranked, "clean": s.clean, "empty": s.empty,
            "dispatches": s.dispatches, "incidents": [s.incidents_opened, s.incidents_resolved],
            "kernel": ranked[0].kernel, "routes": [r.route for r in ranked],
            "batch_windows": groups,
            "n_iters": {r.start: r.rank_iterations for r in ranked},
            "ranked_window_ms_by_stage": stages, "every_window_ms_by_stage": all_stages,
            "wall_s": round(wall, 3), "spans_per_s": round(s.spans / wall, 1),
            "launches": counts,
        }
        if hits:
            # Each warm window's init: [nonzero, length] of sv_n, rv_n,
            # sv_a, rv_a. rv maps by each kind column's representative
            # (its earliest trace, JAX's), which a slide drops.
            out[mode]["warm_init_nonzero_of_length"] = hits
        if mode == "default":
            # The serve phase's co-deploy is held to this run.
            STREAM_SOLO.update(
                counts=(s.windows, s.ranked, s.incidents_opened, s.incidents_resolved),
                results=[(r.start, r.ranking, r.rank_iterations) for r in s.results])
            check(s.dispatches < s.ranked, f"{tag}: {s.dispatches} dispatches for {s.ranked} "
                                           "ranked windows (no coalescing)")
            # Each coalesced window bitwise its own one-window program.
            router = DispatchRouter(cfg, device="cuda")
            for r in ranked:
                if (r.batch_windows or 1) < 2:
                    continue
                g, names, kernel = build_of(builds, r.start)[:3]
                (idx, sc, nv), _ = router.rank_batch([g], kernel)
                own = [(names[int(i)], float(x)) for i, x in zip(idx[0][:int(nv[0])],
                                                                sc[0][:int(nv[0])])]
                check(own == r.ranking, f"{tag}: coalesced window {r.start} is not bitwise its "
                                        "own program")
            out[mode]["coalesced_bitwise_vs_own"] = True
            keys = {bucket_key(v[0], v[2]) for v in builds.values()}
            out[mode]["buckets"] = len(keys)
    # The warm restart: an engine over the default run's manifest
    # dispatches its recorded occupancies and shapes before its first
    # window (counted with the run), then ranks as the default run did.
    recorded = manifest_shapes(str(stream_jit), "stream")
    check(recorded, "stream/warm_restart: the default run recorded no shape")
    reg = get_registry()

    def warm_shapes():
        return {o: reg.get("microrank_warm_shapes_total").value(outcome=o)
                for o in ("warmed", "skipped", "failed")}

    before, timed = warm_shapes(), {}
    s_w, counts_w, _, wall_w, _, _ = stream_run(torch, spmv, pattern, src, "default",
                                                manifest=stream_jit, timed=timed)
    shaped = {o: v - before[o] for o, v in warm_shapes().items()}
    check(shaped["warmed"] == len(recorded) and shaped["failed"] == 0,
          f"stream/warm_restart: recorded shapes {len(recorded)}, replayed {shaped}")
    s_d = runs["default"][0]
    check([(r.start, r.ranking, r.rank_iterations) for r in s_w.results]
          == [(r.start, r.ranking, r.rank_iterations) for r in s_d.results],
          "stream/warm_restart: the restarted engine's results are not the default run's")
    base = launches["stream/default"]
    check(all(counts_w[k] >= base[k] for k in base) and counts_w != base,
          f"stream/warm_restart: launch counts {counts_w}, the default run's {base}")
    launches["stream/warm_restart"] = counts_w
    first_w = next(r for r in s_w.results if r.ranking)
    first_d = next(r for r in s_d.results if r.ranking)
    out["warm_restart"] = {
        "recorded_shapes": [[k, o] for k, o, _ in recorded], "warm_shapes": shaped,
        "warm_start_s": timed.get("warm_start_s"), "wall_s": round(wall_w, 3),
        "cold_wall_s": out["default"]["wall_s"],
        "first_ranked_window_ms_by_stage": {k: first_w.timings.get(k) for k in
                                            ("detect", "build", "rank_ms")},
        "cold_first_ranked_window_ms_by_stage": {k: first_d.timings.get(k) for k in
                                                 ("detect", "build", "rank_ms")},
        "launches": counts_w,
    }
    # Warm vs cold, window by window over the sliding runs.
    cold = {r.start: r for r in runs["cold_sliding"][0].results if r.ranking}
    for mode in ("warm_start", "fused_pair"):
        s, builds, cfg = runs[mode]
        ranked = [r for r in s.results if r.ranking]
        check(set(cold) == {r.start for r in ranked}, f"stream/{mode}: other windows ranked "
                                                      "than the cold run's")
        check(out[mode]["launches"]["setup_warm_launches"] == len(ranked) - 1 >= 1,
              f"stream/{mode}: K19 launches {out[mode]['launches']['setup_warm_launches']} for "
              f"{len(ranked) - 1} warm windows")
        worst, per_window = 0.0, {}
        for r in ranked:
            c = cold[r.start]
            # Window by window: recorded, not gated. JAX's map joins a
            # kind column by its representative, the kind's earliest
            # trace, which the slide drops, so rv starts cold beside a
            # warm sv; JAX's own engine then takes more steps than cold
            # at some windows and over some incidents
            # (tests/test_torch_stream_engine.py, the port equal to it
            # window by window). The seam itself is gated below.
            per_window[r.start] = [r.rank_iterations, c.rank_iterations]
            n_w, s_w = zip(*r.ranking)
            n_c, s_c = zip(*c.ranking)
            ok, why = tie_aware_topk_agreement(list(n_w), list(s_w), list(n_c), list(s_c),
                                               k=len(n_w), rtol=WARM_RTOL)
            check(ok, f"stream/{mode}: window {r.start} vs cold: {why}")
            worst = max(worst, max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(s_w, s_c)))
        # The incident's iterations, warm against cold: recorded, not
        # gated, for the reason above (ROADMAP.md, Faults).
        warm_iters = sum(r.rank_iterations for r in ranked)
        cold_iters = sum(cold[r.start].rank_iterations for r in ranked)
        out[mode].update(iterations_over_incident=warm_iters, cold_iterations=cold_iters,
                         iterations_warm_cold_by_window=per_window,
                         windows_warm_at_most_cold=sum(w <= c for w, c in per_window.values()),
                         max_rel_score_diff_vs_cold=worst)
    # The seam where its map hits (JAX's identical-window replay,
    # tests/test_kind_kernel.py): each ranked window of the warm run
    # ranked cold, then warm from its own state mapped onto itself, stops
    # within 3 steps and in fewer than cold, with the cold ranking.
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.warm import capture_warm_state, map_warm_state

    s, builds, cfg = runs["warm_start"]
    ranked = [r for r in s.results if r.ranking]
    replay = {}
    for r in ranked:
        g, names, kernel, ectx, _ = build_of(builds, r.start)
        dg = tc.device_subset(graph_from_numpy(g, torch.device("cuda")), kernel)
        cold_out = tc.rank_window_warm(dg, None, cfg.pagerank, cfg.spectrum, kernel)
        init = map_warm_state(capture_warm_state(names, ectx, cold_out[5:9]), names, ectx, g)
        again = tc.rank_window_warm(dg, init, cfg.pagerank, cfg.spectrum, kernel)
        it_cold, it_again = int(cold_out[4]), int(again[4])
        replay[r.start] = [it_again, it_cold]
        check(it_again <= 3 < it_cold, f"stream/replay: window {r.start} from its own state took "
                                       f"{it_again} steps, cold {it_cold}")
        n = int(cold_out[2])
        ok, why = tie_aware_topk_agreement([names[int(i)] for i in again[0][:n]],
                                           list(again[1][:n]),
                                           [names[int(i)] for i in cold_out[0][:n]],
                                           list(cold_out[1][:n]), k=n, rtol=WARM_RTOL)
        check(ok and int(again[2]) == n, f"stream/replay: window {r.start} vs cold: {why}")
    out["replay_own_state_iterations_warm_cold"] = replay
    # The warm and cold programs' device time at one warm window: its
    # host graph and the init its run mapped, by events behind a spin.
    r = ranked[len(ranked) // 2]
    g, names, kernel, ectx, _ = build_of(builds, r.start)
    dg = tc.device_subset(graph_from_numpy(g, torch.device("cuda")), kernel)
    state = tc.rank_window_warm(dg, None, cfg.pagerank, cfg.spectrum, kernel)
    init = map_warm_state(capture_warm_state(names, ectx, state[5:9]), names, ectx, g)
    dinit = tc.warm_init_on(dg, init)
    programs = {
        "cold": lambda: tc.rank_window_warm_core(dg, None, cfg.pagerank, cfg.spectrum, kernel),
        "warm": lambda: tc.rank_window_warm_core(dg, dinit, cfg.pagerank, cfg.spectrum, kernel),
    }
    turns = [(k, spin_event_ms(torch, programs[k], 5, PROGRAM_SPIN_CYCLES))
             for k in ("cold", "warm", "warm", "cold")]
    out["program_ms"] = {"window": r.start, "kernel": kernel,
                         **{k: round(_mean([t for kk, t in turns if kk == k]), 6)
                            for k in programs},
                         "turns_ms": [[k, round(t, 6)] for k, t in turns],
                         "note": "the same steps run either way (the tol freezes the carry); "
                                 "the warm program's n_iters is the saving"}
    out["nvidia_smi"] = power_line()
    return launches, out


# The chaos_warehouse phase's runs over the stream phase's timeline: the
# CLI's replay source with the default mode's chunks, lateness and
# pipeline, sealing a warehouse.
CHAOS_STREAM_ARGS = ("--chunk-spans", "200000", "--lateness-seconds", "0",
                     "--pipeline-windows", "3", "--warehouse")
# (a): killed at the checkpoint after the third window (the faulted
# group's: its windows sealed, the checkpoint not written).
CHAOS_KILL = {"seed": 0, "faults": [{"seam": "checkpoint", "kind": "kill", "after": 3,
                                     "count": 1}]}
# (b): two failed dispatches, then a poisoned fetch at the next dispatch
# (three failures in one dispatch would exhaust STREAM_DISPATCH_POLICY).
CHAOS_FAULTS = ({"seam": "dispatch", "kind": "fail", "count": 2},
                {"seam": "fetch", "kind": "nan", "after": 1, "count": 1})


def table_dir(table, path):
    """A span table as a warehouse directory of one record, stored
    uncompressed: ``cli stream --source replay --input`` and ``--normal``
    read it with no CSV parse."""
    import numpy as np

    from microrank_tpu_torch.warehouse import seal_manifest
    from microrank_tpu_torch.warehouse.segment import SEGMENT_SCHEMA, encode_table

    arrays, frame = encode_table(table)
    start, end = int(table.start_us.min()), int(table.end_us.max()) + 1
    meta = {"start": str(start), "end": str(end), "start_us": start, "end_us": end,
            "outcome": "input", "spans": table.n_spans, "frame": frame,
            "schema": SEGMENT_SCHEMA}
    path.mkdir(parents=True)
    name = f"seg-{start}-{end}.npz"
    doc = json.dumps({"schema": SEGMENT_SCHEMA, "windows": [meta]}).encode()
    np.savez(path / name, meta=np.frombuffer(doc, dtype=np.uint8),
             **{f"w0_{k}": v for k, v in arrays.items()})
    seal_manifest(path, {
        "segments": [{"file": name, "tier": "warm", "start_us": start, "end_us": end,
                      "windows": 1, "spans": table.n_spans,
                      "bytes": (path / name).stat().st_size, "outcomes": {"input": 1}}],
        "sealed_through_us": end,
        "counters": {"windows": 1, "spans": table.n_spans, "ingest_rejected": 0},
        "truth": None})


def quiet_cli(cli, argv):
    """``cli.main(argv)`` in this process, its printed windows kept off
    this script's output; returns (exit code, seconds)."""
    import contextlib
    import io

    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    return rc, time.perf_counter() - t


def stage_mean_ms(run_dir, stage):
    """A stage's mean ms from a run's metrics.json (stage_seconds)."""
    doc = json.loads((run_dir / "metrics.json").read_text())
    for smp in doc["metrics"]["microrank_stage_seconds"]["samples"]:
        if smp["labels"].get("stage") == stage and smp["count"]:
            return round(smp["sum"] / smp["count"] * 1e3, 3)
    return None


def phase_chaos_warehouse(torch, spmv, pattern, src, workdir):
    """Crash-only recovery and the trace warehouse on the card, over the
    stream phase's timeline (see the module note). Returns (launch
    counts by run, the phase's line)."""
    import threading

    import numpy as np

    from microrank_tpu_torch import cli
    from microrank_tpu_torch.chaos import load_checkpoint
    from microrank_tpu_torch.config import (
        ChaosConfig,
        DispatchConfig,
        MicroRankConfig,
        RuntimeConfig,
        ServeConfig,
        StreamConfig,
    )
    from microrank_tpu_torch.dispatch import DispatchRouter, bucket_key
    from microrank_tpu_torch.obs import MetricsRegistry, read_journal, set_registry
    from microrank_tpu_torch.sched import DeviceScheduler, ParkedWindowStore
    from microrank_tpu_torch.serve import RankRequest, ServeService
    from microrank_tpu_torch.stream import StreamEngine
    from microrank_tpu_torch.stream.window import stamp
    from microrank_tpu_torch.warehouse import TraceWarehouse, load_manifest, replay_range, run_retro

    reg = MetricsRegistry()
    set_registry(reg)
    os.environ["MICRORANK_JIT_CACHE"] = str(workdir / "chaos_jit")
    base = workdir / "chaos"
    launches = {}
    t = time.perf_counter()
    table_dir(src.table, base / "input")
    table_dir(src.normal, base / "normal")
    out = {"phase": "chaos_warehouse", "windows": STREAM_WINDOWS,
           "timeline_spans": src.table.n_spans, "input_write_s": round(time.perf_counter() - t, 3)}
    argv = ["stream", "--source", "replay", "--input", str(base / "input"), "--normal",
            str(base / "normal"), *CHAOS_STREAM_ARGS]

    def windows_of(run):
        rows = [json.loads(x) for x in (run / "windows.jsonl").read_text().splitlines()]
        return [(r["start"], [tuple(x) for x in r["ranking"] or []], r["rank_iterations"])
                for r in rows]

    def incidents_of(run):
        return [(e["event"], e["incident_id"], e["windows"], e["top"][0][0])
                for e in map(json.loads, (run / "incidents.jsonl").read_text().splitlines())]

    def segments_of(run):
        payload = load_manifest(run / "warehouse")
        return payload["counters"], [(r["file"], r["tier"], r["windows"], r["spans"],
                                      r["outcomes"]) for r in payload["segments"]]

    # (a) The uninterrupted run, then one killed at its fourth checkpoint
    # (os._exit in a subprocess) and resumed.
    ref = base / "ref"
    rc, ref_s = quiet_cli(cli, argv + ["-o", str(ref)])
    check(rc == 0, f"chaos_warehouse: the uninterrupted run exited {rc}")
    # Recorded, not gated: the CLI's config is the stream phase's default
    # mode's (the gates below hold the CLI runs to each other).
    out["cli_bitwise_vs_stream_phase"] = windows_of(ref) == [
        (s, list(r), n) for s, r, n in STREAM_SOLO["results"]]
    plan = base / "kill.json"
    plan.write_text(json.dumps(CHAOS_KILL))
    run = base / "run"
    t = time.perf_counter()
    killed = subprocess.run([sys.executable, "-m", "microrank_tpu_torch.cli", *argv, "-o",
                             str(run), "--chaos", str(plan)], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                            text=True, timeout=600)
    killed_s = time.perf_counter() - t
    check(killed.returncode == 137, f"chaos_warehouse: the killed run exited "
                                    f"{killed.returncode}: {killed.stderr[-2000:]}")
    t = time.perf_counter()
    ckpt = load_checkpoint(run / "state.ckpt")
    load_ms = (time.perf_counter() - t) * 1e3
    sealed_at_kill = load_manifest(run / "warehouse")["counters"]["windows"]
    rc, resume_s = quiet_cli(cli, argv + ["-o", str(run), "--resume"])
    check(rc == 0, f"chaos_warehouse: the resumed run exited {rc}")
    events = incidents_of(run)
    check([e[0] for e in events].count("incident_open") == 1
          and [e[0] for e in events].count("incident_resolve") == 1,
          f"chaos_warehouse/resume: incident events {[e[0] for e in events]}")
    check(events == incidents_of(ref), "chaos_warehouse/resume: incidents differ from the "
                                       "uninterrupted run's")
    check(windows_of(run) == windows_of(ref), "chaos_warehouse/resume: a window's ranking is "
                                              "not bitwise the uninterrupted run's")
    check((run / "result.csv").read_bytes() == (ref / "result.csv").read_bytes(),
          "chaos_warehouse/resume: result.csv differs from the uninterrupted run's")
    check(segments_of(run) == segments_of(ref), "chaos_warehouse/resume: the manifest differs "
                                                "from the uninterrupted run's")
    check(sorted(p.name for p in (run / "warehouse").glob("*.npz"))
          == sorted(p.name for p in (ref / "warehouse").glob("*.npz")),
          "chaos_warehouse/resume: segment files differ")
    seals = [e for e in read_journal(run / "journal.jsonl") if e["event"] == "warehouse_seal"
             and e["tier"] == "warm"]
    check(sum(e["windows"] for e in seals) == STREAM_WINDOWS,
          f"chaos_warehouse/resume: {sum(e['windows'] for e in seals)} window seals for "
          f"{STREAM_WINDOWS} windows (each exactly once)")
    out["resume"] = {
        "killed_exit": killed.returncode, "killed_s": round(killed_s, 3),
        "checkpoint_windows_at_kill": ckpt["summary"]["windows"],
        "windows_sealed_at_kill": sealed_at_kill, "checkpoint_load_ms": round(load_ms, 3),
        "resume_s": round(resume_s, 3), "uninterrupted_s": round(ref_s, 3),
        "incident_events": [e[0] for e in events],
        "seal_ms": stage_mean_ms(ref, "warehouse_seal"),
        "checkpoint_ms": stage_mean_ms(ref, "checkpoint"),
        "segments": segments_of(ref)[0],
        "warehouse_bytes": sum(p.stat().st_size for p in (ref / "warehouse").glob("*.npz")),
    }
    # (b) The stream phase's timeline under two failed dispatches and a
    # poisoned fetch, one window a dispatch: every window ranks, bitwise.
    cfg = MicroRankConfig(
        stream=StreamConfig(allowed_lateness_seconds=0.0, pipeline_windows=1),
        dispatch=DispatchConfig(warmup_manifest=False),
        chaos=ChaosConfig(enabled=True, faults=CHAOS_FAULTS))
    engine = StreamEngine(cfg, src, device="cuda")
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    s = engine.run()
    torch.cuda.synchronize()
    counts = read_counts(spmv, pattern)
    ranked = [r for r in s.results if r.ranking]
    check((s.windows, s.skipped, len(ranked)) == (STREAM_WINDOWS, 0, len(STREAM_FAULTS)),
          f"chaos_warehouse/faults: {s.windows} windows, {s.skipped} skipped, {len(ranked)} "
          "ranked (a window dropped)")
    check([(r.start, r.ranking, r.rank_iterations) for r in s.results] == STREAM_SOLO["results"],
          "chaos_warehouse/faults: results are not bitwise the uninjected run's")
    retries = reg.get("microrank_retry_attempts_total").value(seam="stream_dispatch")
    injected = {(x["labels"]["seam"], x["labels"]["kind"]): x["value"]
                for x in reg.get("microrank_fault_injections_total").samples()}
    check(retries == 3 and injected == {("dispatch", "fail"): 2, ("fetch", "nan"): 1},
          f"chaos_warehouse/faults: {retries} retries, injections {injected}")
    # The poisoned attempt ran its program (one window); the failed
    # dispatches launched nothing.
    expect = expected_counts(ranked[0].kernel, len(ranked) + 1, programs=s.dispatches + 1)
    check(counts == expect, f"chaos_warehouse/faults: launch counts {counts}, want {expect}")
    launches["chaos_warehouse/faults"] = counts
    out["faults"] = {"windows": s.windows, "ranked": len(ranked), "skipped": s.skipped,
                     "dispatches": s.dispatches, "retry_attempts": retries,
                     "injections": {f"{k[0]}/{k[1]}": v for k, v in injected.items()},
                     "launches": counts}
    # (c) cli replay over the uninterrupted run's warehouse, counted.
    stored = [w for w in TraceWarehouse(ref, None).query() if w.outcome == "ranked"]
    kernel = stored[0].kernel
    groups, i = [], 0
    while i < len(stored):
        key = bucket_key(stored[i].graph(), stored[i].kernel)
        j = i + 1
        while (j < len(stored) and j - i < MicroRankConfig().dispatch.coalesce_windows
               and bucket_key(stored[j].graph(), stored[j].kernel) == key):
            j += 1
        groups.append(j - i)
        i = j
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    rc, replay_s = quiet_cli(cli, ["replay", str(ref), "--at", "all", "--json",
                                   str(base / "replay.json")])
    torch.cuda.synchronize()
    counts = read_counts(spmv, pattern)
    report = json.loads((base / "replay.json").read_text())
    check(rc == 0 and report["verdict"] == "match" and report["matched"] == len(stored),
          f"chaos_warehouse/replay: exit {rc}, verdict {report['verdict']}, "
          f"{report['matched']} of {len(stored)} matched")
    expect = expected_counts(kernel, len(stored), programs=len(groups),
                             groups=sum(g > 1 for g in groups))
    check(counts == expect, f"chaos_warehouse/replay: launch counts {counts}, want {expect}")
    launches["chaos_warehouse/replay"] = counts
    router = DispatchRouter(MicroRankConfig(), device="cuda")
    for w in stored:  # each stored blob's own program: its live ranking's bits
        (idx, sc, nv), _ = router.rank_batch([w.graph()], w.kernel, record=False)
        own = [(w.op_names[int(x)], float(v)) for x, v in zip(idx[0][:int(nv[0])],
                                                             sc[0][:int(nv[0])])]
        check(own == w.ranking, f"chaos_warehouse/replay: window {w.meta['start']} is not "
                                "bitwise its stored ranking")
    rows = [json.loads(x) for x in (ref / "windows.jsonl").read_text().splitlines()]
    live_ms = _mean([r["timings"]["rank_ms"] for r in rows if r["ranking"]])
    out["replay"] = {"verdict": report["verdict"], "ranked": report["ranked"],
                     "groups": groups, "elapsed_s": report["elapsed_s"],
                     "replay_ms_a_window": round(report["elapsed_s"] * 1e3 / len(stored), 3),
                     "live_rank_ms_a_window": round(live_ms, 3), "cli_s": round(replay_s, 3),
                     "bitwise_vs_stored": True, "launches": counts}
    # (d) cli scenarios --from-warehouse on the card (K13 a window), and
    # the same retro on the CPU over a copy of the warehouse.
    for who in ("card", "cpu"):
        shutil.copytree(ref / "warehouse", base / f"retro_{who}" / "warehouse")
    policy_env = os.environ["MICRORANK_POLICY_DIR"]
    os.environ["MICRORANK_POLICY_DIR"] = str(base / "policy")
    try:
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        rc, retro_s = quiet_cli(cli, ["scenarios", "--from-warehouse", str(base / "retro_card"),
                                      "--json", str(base / "retro.json")])
        torch.cuda.synchronize()
        counts = read_counts(spmv, pattern)
        t = time.perf_counter()
        cpu = run_retro(base / "retro_cpu", persist_policy=False,
                        config=MicroRankConfig(runtime=RuntimeConfig(device="cpu")))
        cpu_s = time.perf_counter() - t
    finally:
        os.environ["MICRORANK_POLICY_DIR"] = policy_env
    card = json.loads((base / "retro.json").read_text())
    n = card["windows_scored"]
    # A replayed file carries no ground truth: the consensus live top-1
    # stands in (``outcome_source``), on the card and on the CPU alike.
    check(rc == 0 and n == len(stored) and card["outcome_source"] == cpu["outcome_source"],
          f"chaos_warehouse/retro: exit {rc}, {n} windows, {card['outcome_source']}")
    check(len(card["record"]["formulas"]) == 13, "chaos_warehouse/retro: not 13 formula rows")
    check(card["record"]["formulas"] == json.loads(json.dumps(cpu["record"]["formulas"])),
          "chaos_warehouse/retro: the card's 13 rows differ from the CPU's")
    check(card["policy_path"] and Path(card["policy_path"]).exists(),
          "chaos_warehouse/retro: no policy written")
    expect = expected_counts(kernel, n, all_methods=True)
    check(counts == expect,   # K13: one all-methods epilogue a window
          f"chaos_warehouse/retro: launch counts {counts}, want {expect}")
    launches["chaos_warehouse/retro"] = counts
    out["retro"] = {"windows": n, "truth": card["truth"],
                    "outcome_source": card["outcome_source"],
                    "policy": card["policy"]["profiles"], "cli_s": round(retro_s, 3),
                    "retro_ms_a_window": round(retro_s * 1e3 / n, 3),
                    "cpu_ms_a_window": round(cpu_s * 1e3 / n, 3),
                    "map": {m: row["map"] for m, row in card["record"]["formulas"].items()},
                    "rows_equal_cpu": True, "launches": counts}
    # (e) serve --backfill: the warehouse replayed on the backfill lane
    # while the service answers; its answers equal solo.
    scfg = MicroRankConfig(serve=ServeConfig(warmup=False, max_wait_ms=0.0),
                           dispatch=DispatchConfig(warmup_manifest=False))
    w_us = int(src.timeline.window_minutes * 60e6)
    t0 = int(src.timeline.start.astype(np.int64))
    requests = [RankRequest(request_id=f"w{k}", tenant=f"t{k}", dataset="tl",
                            start=stamp(t0 + k * w_us), end=stamp(t0 + (k + 1) * w_us))
                for k in STREAM_FAULTS]

    def answers(svc):
        futures = [svc.submit(r) for r in requests]
        return [(f.result(600).ranking, f.result(600).rank_iterations) for f in futures]

    solo_svc = ServeService(scfg)
    solo_svc.fit_baseline(src.normal)
    solo_svc.add_dataset("tl", src.table)
    solo_svc.start()
    try:
        solo_answers = answers(solo_svc)
    finally:
        solo_svc.shutdown(drain=True)
    store = ParkedWindowStore(scfg.sched, serve_cfg=scfg.serve)
    sched = DeviceScheduler(store)
    sched.start()
    backfill = {}
    t = time.perf_counter()
    try:
        svc = ServeService(scfg, sched=sched)
        svc.fit_baseline(src.normal)
        svc.add_dataset("tl", src.table)
        svc.start()
        th = threading.Thread(target=lambda: backfill.update(replay_range(
            ref, config=scfg, sched=sched)), name="co-backfill")
        th.start()
        co_answers = answers(svc)
        th.join(600)
        check(not th.is_alive(), "chaos_warehouse/backfill: the replay did not end")
        svc.shutdown(drain=True)
    finally:
        sched.stop(drain=True, timeout=60)
    co_s = time.perf_counter() - t
    check(co_answers == solo_answers and all(a for a, _ in solo_answers),
          "chaos_warehouse/backfill: serve's answers differ from solo")
    check(backfill.get("verdict") == "match" and backfill["matched"] == len(stored),
          f"chaos_warehouse/backfill: replay {backfill.get('verdict')}")
    shares = store.tenant_shares()
    check(sched.errors == 0 and shares.get(scfg.sched.backfill_tenant, 0) >= 1,
          f"chaos_warehouse/backfill: scheduler errors {sched.errors}, shares {shares}")
    out["backfill"] = {"verdict": backfill["verdict"], "matched": backfill["matched"],
                       "requests": len(requests), "answers_equal_solo": True,
                       "tenant_shares": shares, "wall_s": round(co_s, 3)}
    out["nvidia_smi"] = power_line()
    return launches, out


# The serve phase's service knobs: batches of up to 8 windows, 200 ms of
# coalescing, a build worker a window of the replay.
SERVE_BATCH, SERVE_WAIT_MS, SERVE_BUILDERS = 8, 200.0, 6


def _serve_post(port, payload, timeout=600, headers=None):
    """One ``POST /rank``: (status, body, headers, client ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rank", data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        out = e.code, json.loads(e.read()), dict(e.headers)
    return (*out, round((time.perf_counter() - t0) * 1e3, 3))


def _stage_ms(header):
    """A Server-Timing header as {stage: ms}."""
    out = {}
    for part in (header or "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if name:
            out[name] = float(dur)
    return out


def _serve_round(port, windows, tag):
    """The replay's windows as concurrent dataset requests: per window
    (status, body, headers, ms), in window order."""
    payloads = [{"dataset": "replay", "start": r.start, "end": r.end, "tenant": f"t{i % 3}",
                 "request_id": f"{tag}-{i}"} for i, r in enumerate(windows)]
    with ThreadPoolExecutor(len(payloads)) as ex:
        return list(ex.map(_serve_post, [port] * len(payloads), payloads))


def phase_serve(torch, spmv, pattern, workdir, replay_windows, fault, src):
    """The online service on the card (see the module note). Returns
    (launch counts by run, the phase's line)."""
    import csv
    import dataclasses
    import signal
    import socket
    import threading
    import urllib.request

    import numpy as np

    from microrank_tpu_torch import cli
    from microrank_tpu_torch.config import (
        DispatchConfig,
        ExplainConfig,
        MicroRankConfig,
        ServeConfig,
        StreamConfig,
    )
    from microrank_tpu_torch.dispatch import manifest_shapes
    from microrank_tpu_torch.evaluation import EvalConfig, _case_config
    from microrank_tpu_torch.explain.bundle import ExplainBundle
    from microrank_tpu_torch.explain.oracle import explain_window_oracle
    from microrank_tpu_torch.graph.table_ops import (
        build_window_graph_from_table,
        detect_window_partition,
        prepare_window_graph,
    )
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.obs import MetricsRegistry, set_registry
    from microrank_tpu_torch.obs.spans import get_tracer
    from microrank_tpu_torch.ops import explain as kx
    from microrank_tpu_torch.sched import DeviceScheduler, ParkedWindowStore
    from microrank_tpu_torch.serve import ServeHandle, ServeService
    from microrank_tpu_torch.serve.protocol import parse_datetime_us
    from microrank_tpu_torch.serve.server import window_rows
    from microrank_tpu_torch.stream import StreamEngine
    from microrank_tpu_torch.testing import generate_case

    t0 = time.perf_counter()
    reg = MetricsRegistry()
    set_registry(reg)
    # The warmup manifest in a directory of this run's own.
    os.environ["MICRORANK_JIT_CACHE"] = str(workdir / "serve_jit")
    out = {"phase": "serve", "max_batch_windows": SERVE_BATCH,
           "max_wait_ms": SERVE_WAIT_MS, "build_workers": SERVE_BUILDERS}
    launches = {}
    t1 = time.perf_counter()
    normal = load_span_table(workdir / "replay" / "normal.csv", cache=False)
    table = load_span_table(workdir / "replay" / "abnormal.csv", cache=False)
    out["load_s"] = round(time.perf_counter() - t1, 3)
    # The replay's ranked windows (its loop's last, partial window ranks
    # nothing).
    replay_windows = [r for r in replay_windows if r.ranking]
    want = {r.start: r.ranking for r in replay_windows}
    out["windows"] = len(replay_windows)

    def serve_config(**serve_kw):
        return MicroRankConfig(serve=ServeConfig(**{
            "max_batch_windows": SERVE_BATCH, "max_wait_ms": SERVE_WAIT_MS,
            "build_workers": SERVE_BUILDERS, **serve_kw}))

    # --- full width, by dataset: two rounds of six concurrent requests.
    svc = ServeService(serve_config(), out_dir=workdir / "serve")
    t1 = time.perf_counter()
    svc.fit_baseline(normal)
    svc.add_dataset("replay", table)
    out["fit_stage_s"] = round(time.perf_counter() - t1, 3)
    svc.start()
    out["warmup_s"] = round(svc.warmup_seconds, 3)
    handle = ServeHandle(svc)
    port = handle.start()
    rounds, kernel = {}, None
    try:
        for tag in ("r1", "r2"):
            torch.cuda.synchronize()
            reset_counts(spmv, pattern)
            d0 = svc.scheduler.batcher.dispatches
            answers = _serve_round(port, replay_windows, tag)
            torch.cuda.synchronize()
            counts = read_counts(spmv, pattern)
            dispatches = svc.scheduler.batcher.dispatches - d0
            bodies = [b for _, b, _, _ in answers]
            for r, (status, body, _, _) in zip(replay_windows, answers):
                check(status == 200, f"serve/{tag}: window {r.start} answered {status}: {body}")
                check(body["ranking"][0][0] == fault,
                      f"serve/{tag}: window {r.start} top-1 {body['ranking'][0][0]}")
                got = [(n, s) for n, s in body["ranking"]]
                check(got == want[r.start], f"serve/{tag}: window {r.start} is not bitwise the "
                                            "replay's TableRCA ranking")
                check(not body["degraded"], f"serve/{tag}: window {r.start} degraded")
            sizes = [b["batch_windows"] for b in bodies]
            check(dispatches < len(bodies) and max(sizes) >= 2,
                  f"serve/{tag}: {dispatches} dispatches for {len(bodies)} requests, batch "
                  f"sizes {sizes}")
            kernel = bodies[0]["kernel"]
            groups = round(sum(1 / b for b in sizes if b > 1))
            expect = expected_counts(kernel, len(bodies), programs=dispatches, groups=groups)
            check(counts == expect, f"serve/{tag}: launch counts {counts}, want {expect}")
            launches[f"serve/{tag}"] = counts
            rounds[tag] = {
                "dispatches": dispatches, "batch_windows": sizes, "kernel": kernel,
                "routes": sorted({b["route"] for b in bodies}),
                "request_ms": [a[3] for a in answers],
                "server_timing_ms": [_stage_ms(a[2].get("Server-Timing")) for a in answers],
                "launches": counts,
            }
        out["rounds"] = rounds
        out["bitwise_vs_table_rca"] = True
        r1, r2 = rounds["r1"]["request_ms"], rounds["r2"]["request_ms"]
        out["first_vs_steady_ms"] = {"first_request": min(r1), "first_round_median":
                                     _median(r1), "steady_round_median": _median(r2)}

        # --- explain: true on one window: one more program, one K15 call.
        r = replay_windows[len(replay_windows) // 2]
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        status, body, headers, ms = _serve_post(
            port, {"dataset": "replay", "start": r.start, "end": r.end,
                                 "explain": True, "request_id": "explain"})
        torch.cuda.synchronize()
        counts = read_counts(spmv, pattern)
        check(status == 200 and body.get("explain"), f"serve/explain: answered {status}")
        check([(n, s) for n, s in body["ranking"]] == want[r.start],
              "serve/explain: the explained request's ranking is not the replay's")
        win = window_rows(table, parse_datetime_us(r.start), parse_datetime_us(r.end))
        win, _ = admit_table(win, svc.config.ingest)
        w0, w1 = int(win.start_us.min()), int(win.end_us.max())
        mask, nrm, abn, _ = detect_window_partition(win, w0, w1, svc.slo_vocab, svc.baseline,
                                                    svc.config.detector)
        g, _, k, _ = prepare_window_graph(win, mask, nrm, abn, svc.config, explain=True)
        ex = ExplainConfig(enabled=True)
        plan = kx.window_plan(g.normal, g.abnormal, k, ex.top_traces, kx.n_suspects(
            min(svc.config.spectrum.n_rows, int(g.normal.cov_unique.shape[0])), ex))
        expect = expected_counts(k, 2, programs=2, explained=(1, plan.kernel_launches))
        check(counts == expect, f"serve/explain: launch counts {counts}, want {expect}")
        launches["serve/explain"] = counts
        g_un, names, codes_n, codes_a = build_window_graph_from_table(
            win, mask, nrm, abn, aux="none", collapse="off")
        ids = win.trace_names
        oracle = explain_window_oracle(g_un, names, [ids[int(c)] for c in codes_n],
                                       [ids[int(c)] for c in codes_a], svc.config.pagerank,
                                       svc.config.spectrum,
                                       aggregate_kinds=int(g.normal.n_cols) >= 0)
        bundle = ExplainBundle(body["explain"])
        ok, why = bundle_vs_oracle(bundle, oracle, ORACLE_RTOL)
        check(ok, f"serve/explain: the bundle against the float64 oracle: {why}")
        # The explained program, its fetch and the bundle (host clock):
        # the request's ``explain`` span.
        span_ms = next((sp.dur_us / 1e3 for sp in get_tracer().snapshot()
                        if sp.name == "explain" and sp.trace_id == "explain"), None)
        out["explain"] = {"window": r.start, "request_ms": ms, "kernel": k,
                          "explain_span_ms": span_ms,
                          "server_timing_ms": _stage_ms(headers.get("Server-Timing")),
                          "top1": bundle.top1(), "oracle_rtol": ORACLE_RTOL,
                          "explain_plan": plan._asdict(), "launches": counts}
    finally:
        handle.stop()
    check(reg.get("microrank_serve_degraded_total").value() == 0,
          "serve: a request that was not injected came back degraded")

    # --- warm restart: a second service over the first one's manifest
    # dispatches the recorded B = 6 shape at startup; its first round
    # against the first service's.
    recorded = manifest_shapes(os.environ["MICRORANK_JIT_CACHE"], "serve")
    check(any(occ == len(replay_windows) for _, occ, _ in recorded),
          f"serve/warm_restart: no B = {len(replay_windows)} shape recorded "
          f"({[occ for _, occ, _ in recorded]})")
    svc_w = ServeService(serve_config(), out_dir=workdir / "serve_warm")
    svc_w.fit_baseline(normal)
    svc_w.add_dataset("replay", table)
    svc_w.start()
    shaped = {o: reg.get("microrank_warm_shapes_total").value(outcome=o)
              for o in ("warmed", "skipped", "failed")}
    check(shaped["warmed"] == len(recorded) and shaped["failed"] == 0,
          f"serve/warm_restart: recorded shapes {len(recorded)}, replayed {shaped}")
    handle_w = ServeHandle(svc_w)
    port = handle_w.start()
    try:
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        d0 = svc_w.scheduler.batcher.dispatches
        answers = _serve_round(port, replay_windows, "warm")
        torch.cuda.synchronize()
        counts = read_counts(spmv, pattern)
        dispatches = svc_w.scheduler.batcher.dispatches - d0
    finally:
        handle_w.stop()
    for r, (status, body, _, _) in zip(replay_windows, answers):
        check(status == 200 and not body["degraded"]
              and [(n, x) for n, x in body["ranking"]] == want[r.start],
              f"serve/warm_restart: window {r.start} answered {status}, not the replay's ranking")
    sizes = [b["batch_windows"] for _, b, _, _ in answers]
    expect = expected_counts(kernel, len(answers), programs=dispatches,
                             groups=round(sum(1 / b for b in sizes if b > 1)))
    check(counts == expect, f"serve/warm_restart: launch counts {counts}, want {expect}")
    launches["serve/warm_restart"] = counts
    warm_ms = [a[3] for a in answers]
    out["warm_restart"] = {
        "recorded_shapes": [[k, o] for k, o, _ in recorded], "warm_shapes": shaped,
        "warmup_s": round(svc_w.warmup_seconds, 3), "cold_warmup_s": out["warmup_s"],
        "dispatches": dispatches, "batch_windows": sizes, "request_ms": warm_ms,
        "server_timing_ms": [_stage_ms(a[2].get("Server-Timing")) for a in answers],
        "first_round_median_ms": _median(warm_ms),
        "cold_first_round_median_ms": _median(rounds["r1"]["request_ms"]),
        "rank_stage_median_ms": _median([_stage_ms(a[2].get("Server-Timing")).get("rank", 0.0)
                                         for a in answers]),
        "cold_rank_stage_median_ms": _median([t.get("rank", 0.0) for t in
                                              rounds["r1"]["server_timing_ms"]]),
        "launches": counts,
    }

    # --- inline spans: the eval harness's default case, against cli run.
    case = generate_case(_case_config(EvalConfig(), EvalConfig().seed0))
    normal_csv, abnormal_csv = case.write_csvs(workdir / "serve_eval")
    with open(abnormal_csv, newline="") as f:
        records = list(csv.DictReader(f))
    run_out = workdir / "serve_eval" / "run"
    rc = cli.main(["run", "--normal", str(normal_csv), "--abnormal", str(abnormal_csv),
                   "-o", str(run_out), "--detect-minutes", "600", "--skip-minutes", "600"])
    check(rc == 0, f"serve/inline: cli run exited {rc}")
    lines = [json.loads(x) for x in (run_out / "windows.jsonl").read_text().splitlines()]
    run_ranking = [tuple(x) for x in lines[0]["ranking"]]
    check(run_ranking and run_ranking[0][0] == case.fault_pod_op,
          f"serve/inline: cli run's window ranked {run_ranking[:1]}")
    eval_normal = load_span_table(normal_csv, cache=False)

    def eval_service(**serve_kw):
        s2 = ServeService(serve_config(warmup=False, **serve_kw),
                          out_dir=workdir / "serve_inline")
        s2.fit_baseline(eval_normal)
        s2.start()
        return s2, ServeHandle(s2)

    svc2, h2 = eval_service()
    port = h2.start()
    try:
        status, body, _, inline_ms = _serve_post(port, {"spans": records, "request_id": "inline"})
        check(status == 200 and not body["degraded"], f"serve/inline: answered {status}")
        check([tuple(x) for x in body["ranking"]] == run_ranking,
              "serve/inline: the inline answer is not bitwise cli run's on the same CSV pair")
    finally:
        h2.stop()
    out["inline"] = {"spans": len(records), "request_ms": inline_ms, "kernel": body["kernel"],
                     "bitwise_vs_cli_run": True}

    # --- a failed dispatch: two injected failures answer 500 on the card
    # (no numpy_ref fallback there, ``fallback`` on as by default), with
    # a ``degraded`` flight dump; then the card again.
    svc3, h3 = eval_service(inject_dispatch_failures=2, max_batch_windows=1)
    check(svc3.serve.fallback and not svc3.scheduler.batcher.fallback(),
          "serve/failed_dispatch: the numpy_ref fallback is armed on the card")
    port = h3.start()
    try:
        status, body, _, failed_ms = _serve_post(port, {"spans": records,
                                                        "request_id": "failed"})
        check(status == 500 and "injected" in body.get("error", ""),
              f"serve/failed_dispatch: answered {status}: {body}")
        status2, body2, _, _ = _serve_post(port, {"spans": records, "request_id": "recovered"})
        check(status2 == 200 and not body2["degraded"] and body2["kernel"] != "numpy_ref"
              and [tuple(x) for x in body2["ranking"]] == run_ranking,
              "serve/failed_dispatch: the request after the injected failures did not rank on "
              "the card")
    finally:
        h3.stop()
    check(reg.get("microrank_serve_degraded_total").value() == 0,
          "serve/failed_dispatch: a request came back degraded on the card")
    failed = reg.get("microrank_serve_requests_total").value(outcome="failed")
    dumps = sorted(d.name.rsplit("-", 1)[-1] for d in (workdir / "serve_inline" / "flight").iterdir())
    check("degraded" in dumps, f"serve/failed_dispatch: flight dumps {dumps}")
    out["failed_dispatch"] = {"status": status, "request_ms": failed_ms, "flight_dumps": dumps,
                              "requests_failed": failed, "degraded_counter": 0}

    # --- admission: a queue of depth 1 answers 429 with a Retry-After.
    svc4, h4 = eval_service(max_queue_depth=1, max_wait_ms=3000.0)
    port = h4.start()
    try:
        with ThreadPoolExecutor(1) as ex:
            parked = ex.submit(_serve_post, port, {"spans": records, "request_id": "parked"})
            deadline = time.monotonic() + 30
            while svc4.admission.depth < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            status, body, headers, _ = _serve_post(port, {"spans": records,
                                                          "request_id": "shed"})
            check(status == 429 and headers.get("Retry-After"),
                  f"serve/429: answered {status} (Retry-After {headers.get('Retry-After')})")
            check(parked.result()[0] == 200, "serve/429: the admitted request was dropped")
    finally:
        h4.stop()
    out["admission"] = {"status": 429, "retry_after": headers.get("Retry-After")}

    # --- co-deploy: serve and the stream timeline through one scheduler.
    scfg = MicroRankConfig(stream=StreamConfig(allowed_lateness_seconds=0.0, pipeline_windows=3),
                           dispatch=DispatchConfig(warmup_manifest=False))
    base = serve_config(warmup=False)
    store = ParkedWindowStore(scfg.sched, serve_cfg=base.serve)
    sched = DeviceScheduler(store)
    sched.start()
    t1 = time.perf_counter()
    try:
        svc5 = ServeService(base, sched=sched)
        svc5.fit_baseline(normal)
        svc5.add_dataset("replay", table)
        svc5.start()
        h5 = ServeHandle(svc5)
        co_port = h5.start()
        engine = StreamEngine(scfg, src, device="cuda", sched=sched)
        res = {}
        th = threading.Thread(target=lambda: res.update(s=engine.run()), name="co-stream")
        th.start()
        answers = _serve_round(co_port, replay_windows, "co")
        th.join(timeout=900)
        check(not th.is_alive(), "serve/codeploy: the stream engine did not finish")
        h5.stop()
    finally:
        sched.stop(drain=True, timeout=120)
    co_s = time.perf_counter() - t1
    s = res["s"]
    check((s.windows, s.ranked, s.incidents_opened, s.incidents_resolved)
          == STREAM_SOLO["counts"],
          f"serve/codeploy: stream {(s.windows, s.ranked, s.incidents_opened)} vs solo "
          f"{STREAM_SOLO['counts']}")
    check([(r.start, r.ranking, r.rank_iterations) for r in s.results]
          == STREAM_SOLO["results"], "serve/codeploy: the stream's rankings are not its solo run's")
    for r, (status, body, _, _) in zip(replay_windows, answers):
        check(status == 200 and [(n, x) for n, x in body["ranking"]] == want[r.start],
              f"serve/codeploy: window {r.start} answered {status}, not the solo service's")
    shares = store.tenant_shares()
    check(sched.errors == 0 and shares.get("stream", 0) > 0
          and sum(v for k, v in shares.items() if k != "stream") >= len(replay_windows),
          f"serve/codeploy: scheduler errors {sched.errors}, tenant shares {shares}")
    out["codeploy"] = {"stream": [s.windows, s.ranked, s.incidents_opened,
                                  s.incidents_resolved],
                       "stream_equals_solo": True, "serve_equals_solo": True,
                       "tenant_shares": shares, "sched_dispatched": sched.dispatched,
                       "sched_errors": sched.errors,
                       "request_ms": [a[3] for a in answers], "wall_s": round(co_s, 3)}

    # --- the CLI as a process: one request, SIGTERM, the drain.
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        cli_port = sk.getsockname()[1]
    cli_out = workdir / "serve_cli"
    env = {**os.environ, "MICRORANK_JIT_CACHE": str(workdir / "serve_cli_jit")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "microrank_tpu_torch.cli", "serve", "--normal", str(normal_csv),
         "--dataset", f"case={abnormal_csv}", "--port", str(cli_port), "-o", str(cli_out),
         "--max-wait-ms", "50"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t1 = time.perf_counter()
    try:
        up = False
        while time.perf_counter() - t1 < 300 and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{cli_port}/healthz",
                                            timeout=10) as r:
                    up = r.status == 200
                break
            except OSError:
                time.sleep(0.25)
        check(up, f"serve/cli: the service never came up (exit {proc.poll()})")
        up_s = time.perf_counter() - t1
        status, body, _, cli_ms = _serve_post(cli_port, {"dataset": "case"})
        check(status == 200 and [tuple(x) for x in body["ranking"]] == run_ranking,
              f"serve/cli: answered {status}, not cli run's ranking")
        proc.send_signal(signal.SIGTERM)
        log, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    check(proc.returncode == 0 and "drained" in log,
          f"serve/cli: exit {proc.returncode}: {log[-800:]}")
    cli_dumps = [d.name.rsplit("-", 1)[-1] for d in (cli_out / "flight").iterdir()]
    check("sigterm" in cli_dumps, f"serve/cli: flight dumps {cli_dumps}")
    out["cli"] = {"up_s": round(up_s, 3), "request_ms": cli_ms, "exit": proc.returncode,
                  "flight_dumps": cli_dumps}
    out["nvidia_smi"] = power_line()
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    return launches, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument(
        "--replay-windows", type=int, default=6,
        help="windows of the replay timeline (bench.py's config 5 has 8 of "
             "--spans spans each); 0 skips the replay phase",
    )
    ap.add_argument(
        "--giant-spans", type=int, default=GIANT_SPANS,
        help="spans of the larger giant window (the smaller holds a fifth; the "
             "dense budget scales with it from 2 GiB at the default); 0 skips "
             "the giant phase",
    )
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "microrank_tpu_torch" / "__init__.py").is_file():
        print(
            f"chip_smoke: the port (microrank_tpu_torch/) is not beside {ROOT}",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, str(ROOT))
    from microrank_tpu_torch import native
    from microrank_tpu_torch.ops import pattern, spmv

    phase = "env"
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "bench_data"
                                    if (ROOT / "bench_data").is_dir() else ROOT))
    # No tuned policy reaches a run but the policy phase's: an empty
    # policy directory of this run's own.
    empty_policy_dir = workdir / "no_policy"
    empty_policy_dir.mkdir()
    os.environ["MICRORANK_POLICY_DIR"] = str(empty_policy_dir)
    # The warmup manifest (serve, stream) in this run's directory.
    os.environ["MICRORANK_JIT_CACHE"] = str(workdir / "jit")
    try:
        env = phase_env(torch, spmv, pattern, native)
        emit(env)
        phase = "data"
        case, normal, abnormal, data = phase_data(args, workdir)
        emit(data)
        phase = "run"
        launches, graphs, results = {}, {}, {}
        for kernel in ("pallas", "auto"):
            for collapse in ("auto", "off"):
                graph, counts, res, info = phase_run(
                    torch, spmv, pattern, case, normal, abnormal, collapse, kernel
                )
                launches[f"{kernel}/{collapse}"] = counts
                graphs[f"{kernel}/{collapse}"] = graph
                results[f"{kernel}/{collapse}"] = res
                emit(info)
        # Past the dense budget: the default auto, collapse off, at lowered
        # budgets.
        budgets = lowered_budgets(graphs["pallas/off"])
        for want in ("packed_blocked", "pcsr"):
            graph, counts, res, info = phase_run(
                torch, spmv, pattern, case, normal, abnormal, "off", "auto",
                budgets[want], want,
            )
            launches[f"auto/{want}"] = counts
            graphs[f"auto/{want}"] = graph
            if want == "pcsr":
                same = [(r.ranking, r.rank_iterations) for r in res] == [
                    (r.ranking, r.rank_iterations) for r in results["pallas/off"]
                ]
                check(same, "pcsr: ranking is not bitwise the pinned pallas run's")
                info["ranking_bitwise_vs_pallas"] = True
            emit(info)
        # kind_precision="int8": auto, collapse on, resolves to kind; one
        # scale launch and one int8 pair launch per step.
        phase = "int8"
        graph, counts, res, info = phase_run(
            torch, spmv, pattern, case, normal, abnormal, "on", "auto", precision="int8",
        )
        launches["auto/int8"] = counts
        graphs["auto/int8"] = graph
        info["phase"] = "int8"
        emit(info)
        phase = "policy"
        counts, info = phase_policy(torch, spmv, pattern, normal, abnormal, workdir,
                                    empty_policy_dir)
        launches["policy"] = counts
        emit(info)
        phase = "staging"
        emit(phase_staging(torch, spmv, pattern, graphs))
        phase = "replay"
        batched = replay = replay_windows = None
        if args.replay_windows:
            replay, replay_windows, replay_launches, info = phase_replay(
                torch, spmv, pattern, args, workdir
            )
            replay_fault = replay[0].fault_pod_op
            launches.update(replay_launches)
            emit(info)
            phase = "follow"
            counts, info = phase_follow(torch, spmv, pattern, *replay, workdir)
            launches["follow"] = counts
            emit(info)
            phase = "batched"
            batched_launches, batched = phase_batched(
                torch, spmv, pattern, replay, replay_windows, graphs
            )
            launches.update(batched_launches)
            emit(batched)
            phase = "quarantine"
            emit(phase_quarantine(torch, spmv, pattern, *replay[:3], workdir))
        phase = "families"
        family_launches, families = phase_families(
            torch, spmv, pattern, case, normal, abnormal, graphs, results, replay,
            replay_windows)
        launches.update(family_launches)
        emit(families)
        del replay
        phase = "eval"
        eval_launches, evals = phase_eval(torch, spmv, pattern, args)
        launches.update(eval_launches)
        emit(evals)
        phase = "kernel"
        per_matrix, per_step = phase_kernel(torch, spmv, graphs, args.reps)
        emit({"phase": "kernel", "per_matrix": per_matrix, "per_step": per_step,
              "rtol": KERNEL_RTOL})
        phase = "pattern"
        pairs = phase_pattern(torch, pattern, graphs)
        emit({"phase": "pattern", "per_step": pairs, "rtol": KERNEL_RTOL,
              "packed_bf16_sweep": pattern_sweep(torch, pattern)})
        phase = "step"
        steps = phase_step(torch, graphs, args.reps)
        emit(steps)
        phase = "giant"
        giant, giant_steps, giant_folds, giant_k6, giant_stacked_err = {}, {}, {}, {}, {}
        giant_group, giant_k13, giant_k19, giant_k15 = {}, None, None, {}
        if args.giant_spans:
            budget = DEFAULT_BUDGET * args.giant_spans // GIANT_SPANS
            for n_spans, want in ((args.giant_spans // 5, "packed_blocked"),
                                  (args.giant_spans, "pcsr")):
                counts, (kern, step_kern, fold_kern, k6), info, stacked_counts = phase_giant(
                    torch, spmv, pattern, n_spans, budget, want, args.reps
                )
                launches[f"giant/{want}"] = counts
                launches[f"giant_stacked/{want}"] = stacked_counts
                giant_stacked_err[want] = info["stacked"]["max_abs_err"]
                giant_group[want] = info["stacked"]["step_split"]["stacked"]
                giant[want] = kern
                giant_steps[want] = step_kern
                giant_folds[want] = fold_kern
                giant_k6[want] = k6
                giant_k13 = info.pop("k13", giant_k13)
                giant_k19 = info.pop("k19", giant_k19)
                giant_k15[want] = info.pop("k15")
                emit(info)
                torch.cuda.empty_cache()
        # K13 at the config-5 kind window (V 3,072) and the 10M-span giant
        # window (V 2,048, measured inside the giant phase).
        phase = "k13"
        from microrank_tpu_torch.config import MicroRankConfig
        from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
        from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

        kind = device_subset(graph_from_numpy(host_subset(graphs["auto/auto"], "kind"),
                                              torch.device("cuda")), "kind")
        k13 = {"phase": "k13",
               "config5_kind": measure_k13(torch, "k13/config5_kind", kind, MicroRankConfig(),
                                           "kind", args.reps),
               "giant_10m": giant_k13}
        emit(k13)
        phase = "k19"
        k19 = {"phase": "k19",
               "config5_kind": measure_k19(torch, "k19/config5_kind", kind, MicroRankConfig(),
                                           "kind", args.reps),
               "giant_10m": giant_k19, "nvidia_smi": power_line()}
        emit(k19)
        del kind
        phase = "stream"
        src, gen_s = stream_source(args)
        stream_launches, stream = phase_stream(torch, spmv, pattern, args, src, gen_s,
                                               workdir)
        launches.update(stream_launches)
        emit(stream)
        phase = "explain"
        explain_launches, explained = phase_explain(torch, spmv, pattern, graphs, giant_k15,
                                                    src, workdir)
        launches.update(explain_launches)
        k15s = explained["k15"]
        emit(explained)
        if replay_windows is not None:
            phase = "serve"
            serve_launches, served = phase_serve(torch, spmv, pattern, workdir, replay_windows,
                                                 replay_fault, src)
            launches.update(serve_launches)
            emit(served)
        phase = "chaos_warehouse"
        chaos_launches, chaos = phase_chaos_warehouse(torch, spmv, pattern, src, workdir)
        launches.update(chaos_launches)
        emit(chaos)
        del src
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    step = per_step["off"]
    kind, packed, int8 = pairs["kind_f32"], pairs["packed_bf16"], pairs["kind_int8"]
    # The window-axis kernels' errors against their plain versions in
    # the stacked groups (0.0 where bitwise), by route.
    stacked_err = {} if batched is None else {
        "kind": max(v.get("max_abs_err", 0.0) for v in batched["kind"].values()),
        "kind_int8": max(v["max_abs_err"] for v in batched["kind_int8"].values()),
        **{k: batched[k]["max_abs_err"]
           for k in ("pallas", "packed_bf16", "packed_blocked", "pcsr")},
    }
    for want, err in giant_stacked_err.items():
        stacked_err[want] = max(err, stacked_err.get(want, 0.0))
    # The stacked groups' launches (K18: one launch of each kernel a step
    # for a group): the batched phase's, the giant groups', the replay's
    # stacked modes'.
    stacked_keys = ("batched/", "giant_stacked/", *(f"replay/{m}" for m in STACKED_MODES))
    int8_keys = ("auto/int8", "replay/chunked_int8", "batched/kind_int8/")

    def stacked_launches(name, prefix=stacked_keys):
        return sum(c[name] for k, c in launches.items() if k.startswith(prefix))
    # packed_blocked runs K8's kernel: at the giant window of a fifth of
    # --giant-spans, else at the config-5 packed_blocked run's shapes.
    blocked = giant.get("packed_blocked", pairs["packed_blocked"])
    pcsr = giant.get("pcsr", per_step["pcsr"])
    # K5 at the 10M-span giant window's shapes, else the config-5 kind
    # window's.
    power = giant_steps.get("pcsr", steps["kind"])
    # The fixed-order fold at the 10M-span window's set-up shape, else
    # the uncollapsed config-5 window's.
    row_fold = giant_folds.get("pcsr", steps["fold"])
    # K6 at the 10M-span window's set-up shape (its epilogue at its 2,048
    # ops), beside the config-5 kind window's; bitwise everywhere it ran.
    k6 = giant_k6.get("pcsr", steps["k6"])
    k6_c5 = steps["k6"]
    # K5's group kernel: the 10M-span window stacked twice, else the
    # config-5 kind group of six (each from its step split).
    group_c5 = {} if batched is None else batched["kind"].get("6", {}).get("step_split", {})
    group_2m = giant_group.get("packed_blocked", {})
    group_step = giant_group.get("pcsr", group_c5)
    # Times are CUDA events around one call behind a device spin (the
    # kernel's own time; torch.profiler's summed device time misreads
    # this card's launches, see timer_check), library_ms and plain_ms
    # the same.
    # Where the command's time went: seconds since the start at each
    # phase's line (a repeated phase is keyed with "+").
    emit({"phase_end_seconds": PHASE_SECONDS})
    emit({"kernels": [
        {
            "name": "coo_spmv",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/coo_spmv.cu",
            "replaces": "microrank_tpu/ops/pallas_spmv.py:95",
            # Every run's K1 launches: the pinned pallas runs (six SpMVs
            # a launch), the auto runs and the replay (the two call-graph
            # terms).
            "launches": sum(c["k1_launches"] for c in launches.values()),
            # Of them, the stacked groups' (one launch a step for the group).
            "stacked_launches": stacked_launches("k1_launches"),
            "max_abs_err": max([r["max_abs_err"] for r in
                                [*per_matrix, *(v for k, v in per_step.items() if k != "pcsr")]]
                               + list(stacked_err.values())),
            # Times are one power-iteration step (one launch, six SpMVs:
            # p_sr, p_ss, p_rs of both partitions) at the uncollapsed
            # config-5 shapes; library_ms is six CSR matvecs.
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"],
            "library_ms": step["library_ms"],
            # K11 (coo: the pallas work list) runs on this kernel: one
            # step at the uncollapsed config-5 window of its families run,
            # and its launches on the main path (runs and stacked groups).
            "families": {
                kernel: {
                    "replaces": "microrank_tpu/rank_backends/jax_tpu.py:405",
                    "launches": sum(c["k1_launches"] for k, c in launches.items()
                                    if k.startswith((f"families/{kernel}/",
                                                     f"families/stacked/{kernel}/"))),
                    **{key: families["runs"][f"{kernel}/off"]["k1"][key]
                       for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err")},
                }
                for kernel in ("coo",)
            },
        },
        {
            "name": "csr_scan",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/csr_scan.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:671",
            # K10: the csr route's six products a step in JAX's order of
            # sums (the double-f32 prefix scan of jax_tpu.py:671-700), one
            # cooperative launch of scan_step a step; scan_pass and row_diff
            # are the level passes, timed in turns (levels_design_ms)
            # and taking only matrices past 2048^2 entries.
            "kernels": ["scan_step", "scan_pass", "row_diff"],
            "launches": sum(c["csr_scan_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("csr_scan_launches"),
            "max_abs_err": families["runs"]["csr/off"]["csr_scan"]["max_abs_err"],
            # One step at the uncollapsed config-5 window (_collapsed: the
            # collapsed one's); levels_design_ms is the level passes and
            # previous_design_ms K1 over the csr work list (K1's design),
            # in turns; library_ms six CSR matvecs of the same views.
            **{key: families["runs"]["csr/off"]["csr_scan"][key]
               for key in ("ms", "levels_design_ms", "previous_design_ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "launches_a_call")},
            **{f"{key}_collapsed": families["runs"]["csr/auto"]["csr_scan"][key]
               for key in ("ms", "levels_design_ms", "previous_design_ms", "bound_ms",
                           "library_ms")},
        },
        {
            "name": "kind_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:558",
            # The f32 kind runs' launches: the collapsed auto run, the
            # policy run, the replay's and the follower's.
            "launches": sum(c["pattern_launches"] for k, c in launches.items()
                            if k in ("auto/auto", "policy", "follow")
                            or k.startswith(("replay/", "batched/kind/", "batched/kind_bf16/"))
                            and not k.startswith(int8_keys)),
            "stacked_launches": stacked_launches(
                "pattern_launches",
                ("batched/kind/", "batched/kind_bf16/",
                 *(f"replay/{m}" for m in STACKED_MODES if m != "chunked_int8"))),
            "max_abs_err": max([pairs[k]["max_abs_err"] for k in ("kind_f32", "kind_bf16")]
                               + [stacked_err.get("kind", 0.0)]),
            # One step (one launch, both partitions, both directions) at
            # the collapsed config-5 shapes, kind_precision f32; library_ms
            # is four torch.matmul calls over the cast matrices.
            "ms": kind["ms"],
            "plain_ms": kind["plain_ms"],
            "bound_ms": kind["bound_ms"],
            "bound_by": kind["bound_by"],
            "library_ms": kind["library_ms"],
        },
        {
            "name": "kind_pair_int8",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:544",
            "launches": stacked_launches("pattern_launches", int8_keys),
            "stacked_launches": stacked_launches("pattern_launches", int8_keys[1:]),
            "max_abs_err": max(int8["max_abs_err"], stacked_err.get("kind_int8", 0.0)),
            # One int8 step's pair launch (both partitions, both
            # directions) at the collapsed config-5 shapes of the int8 run,
            # on fixed scales, as a step now launches it (the step kernel
            # gives the scales); ms_with_scale_launch is the scale launch
            # and the pair together, as every step ran them before, and
            # plain_ms the plain version of both. library_ms is one
            # torch._int_mm per direction and partition
            # (int8["library_form"] says which).
            "ms": int8["pair_ms"],
            "ms_with_scale_launch": int8["ms"],
            "plain_ms": int8["plain_ms"],
            "bound_ms": int8["bound_ms"],
            "bound_by": int8["bound_by"],
            "library_ms": int8["library_ms"],
        },
        {
            "name": "quantize_amax",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:96",
            "launches": stacked_launches("quantize_launches", int8_keys),
            "stacked_launches": stacked_launches("quantize_launches", int8_keys[1:]),
            "max_abs_err": int8["scale_max_abs_err"],
            # One launch per int8 window now (the first step's scales;
            # the step kernel takes every later step's). The launch alone
            # (the four operands' maxima and scales); its bound reads the
            # four operands and their weights once. No single PyTorch call
            # computes the four scales: library_ms is null.
            "ms": int8["scale_ms"],
            "plain_ms": int8["scale_plain_ms"],
            "bound_ms": int8["scale_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "packed_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:419",
            "launches": launches["auto/off"]["pattern_launches"]
            + stacked_launches("pattern_launches", "batched/packed_bf16/"),
            "stacked_launches": stacked_launches("pattern_launches", "batched/packed_bf16/"),
            "max_abs_err": max([pairs[k]["max_abs_err"] for k in ("packed", "packed_bf16")]
                               + [stacked_err.get("packed_bf16", 0.0)]),
            # One step at the uncollapsed config-5 shapes, packed_bf16
            # (what auto runs there).
            "ms": packed["ms"],
            "plain_ms": packed["plain_ms"],
            "bound_ms": packed["bound_ms"],
            "bound_by": packed["bound_by"],
            "library_ms": packed["library_ms"],
        },
        {
            "name": "packed_blocked_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:605",
            "launches": sum(c["blocked_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("blocked_launches"),
            "max_abs_err": max(blocked["max_abs_err"], stacked_err.get("packed_blocked", 0.0)),
            # One step (one launch of K8's kernel, both partitions, both
            # directions, f32) at the giant window's shapes; library_ms is
            # four f32 torch.matmul calls over the unpacked matrices;
            # previous_design_ms the tile kernel (K4's) on the same
            # inputs in the same run.
            "ms": blocked["ms"],
            "previous_design_ms": blocked["previous_design_ms"],
            "plain_ms": blocked["plain_ms"],
            "bound_ms": blocked["bound_ms"],
            "bound_by": blocked["bound_by"],
            "library_ms": blocked["library_ms"],
        },
        {
            "name": "pcsr_group",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/coo_spmv.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:715",
            "launches": sum(c["pcsr_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("pcsr_launches"),
            "max_abs_err": max(pcsr["max_abs_err"], stacked_err.get("pcsr", 0.0)),
            # One step (one launch, six SpMVs: K1's work items over the op
            # side and the call edges, the trace side from the ELL slabs)
            # at the giant window's shapes; library_ms is six CSR matvecs.
            "ms": pcsr["ms"],
            "plain_ms": pcsr["plain_ms"],
            "bound_ms": pcsr["bound_ms"],
            "bound_by": pcsr["bound_by"],
            "library_ms": pcsr["library_ms"],
        },
        {
            "name": "power_step",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/power_step.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:859",
            # Every counted main path's launches of a window's step_grid<S>:
            # one a step on every route (one cooperative launch); a group
            # of two windows or more launches step_grid_group<S> (below).
            "launches": sum(c["step_launches"] - c["step_group_launches"]
                            for c in launches.values()),
            "stacked_launches": stacked_launches("step_launches")
            - stacked_launches("step_group_launches"),
            "instantiations": sorted(k for k in MAIN_STEP_KERNELS
                                     if k.startswith("step_grid<")),
            "max_abs_err": max(m["max_abs_err"] for m in
                               [steps["kind"], steps["kind_int8"], *giant_steps.values()]),
            # One step (one launch, both partitions) at the 10M-span giant
            # window's shapes (_config5_kind: the collapsed config-5 kind
            # window's, _giant_2m: the 2M-span window's). The bound reads
            # the three products, pref and the carry once and writes the
            # new carry once. No single PyTorch call computes the step (a
            # damped combination, two maxima, two divisions and the
            # residual maxima): library_ms is null.
            "ms": power["ms"],
            "ms_config5_kind": steps["kind"]["ms"],
            **({} if "packed_blocked" not in giant_steps else {
                "ms_giant_2m": giant_steps["packed_blocked"]["ms"],
            }),
            "plain_ms": power["plain_ms"],
            "plain_ms_config5_kind": steps["kind"]["plain_ms"],
            "bound_ms": power["bound_ms"],
            "bound_by": power["bound_by"],
            "library_ms": None,
        },
        {
            "name": "step_grid_group",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/power_step.cu",
            # K5 under vmap: _partition_step and window_weights_full's
            # step body in JAX's batched programs
            # (parallel/sharded_rank.py:1043 rank_windows_batched).
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:859",
            # Every counted stacked group's step launches (groups of two
            # windows or more: one a step for the whole group), and the
            # instantiations they launched.
            "launches": stacked_launches("step_group_launches"),
            "instantiations": sorted(k for k in MAIN_STEP_KERNELS
                                     if k.startswith("step_grid_group")),
            # Bitwise the plain step over chains of 50 launches at every
            # group's shapes (a gate).
            "max_abs_err": 0.0,
            # One step of the group (one launch, 2B partitions) at the
            # 10M-span window stacked twice (_giant_2m: the 2M-span
            # window's, _config5_kind_6: the config-5 kind group of six);
            # previous_design_ms PR 13's group kernel on the same inputs
            # in the same run, in turns; recomputed_ms the values past
            # the slots recomputed in place of held. The bound: the
            # group's bytes (B windows' products, pref and carry read
            # once, the new carry written once). No single PyTorch call
            # computes the step: library_ms is null.
            "ms": group_step.get("step_ms"),
            "previous_design_ms": group_step.get("previous_design_ms"),
            "recomputed_ms": group_step.get("recomputed_ms"),
            "plan": group_step.get("plan"),
            **{f"{k}_giant_2m": group_2m.get(k) for k in ("step_ms", "previous_design_ms")},
            **{f"{k}_config5_kind_6": group_c5.get(k)
               for k in ("step_ms", "previous_design_ms")},
            "plain_ms": group_step.get("plain_step_ms"),
            "bound_ms": group_step.get("bound_ms"),
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "rank_setup",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/rank_setup.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:44",
            # One launch a program (a stacked group's one for all its
            # windows): jax_tpu.py:44 preference_vector and :285
            # _partition_setup's initial vectors, both partitions. The
            # rows form (setup_rows: a block or a cluster a row) or, for
            # rows past 8 tiles, the grid form (setup_grid); the first
            # design (setup_first) timed in turns.
            "kernels": ["setup_rows", "setup_grid"],
            "launches": sum(c["setup_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("setup_launches"),
            "max_abs_err": 0.0,
            # One launch at the 10M-span window's set-up shape (the grid
            # form; _config5_kind: the collapsed config-5 kind window's,
            # a block a row). No single PyTorch call computes the
            # set-up: library_ms null.
            "ms": k6["setup"]["ms"],
            "first_design_ms": k6["setup"]["first_design_ms"],
            "ms_config5_kind": k6_c5["setup"]["ms"],
            "first_design_ms_config5_kind": k6_c5["setup"]["first_design_ms"],
            "form": k6["setup"]["plan"]["form"],
            "form_config5_kind": k6_c5["setup"]["plan"]["form"],
            "host_issue_ms": k6["setup"]["host_issue_ms"],
            "plain_ms": k6["setup"]["plain_ms"],
            "plain_ms_config5_kind": k6_c5["setup"]["plain_ms"],
            "bound_ms": k6["setup"]["bound_ms"],
            "bound_ms_config5_kind": k6_c5["setup"]["bound_ms"],
            "bound_by": k6["setup"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "rank_setup_warm",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/rank_setup.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:1578",
            # K19: the set-up's warm instances (setup_rows<C, true>,
            # setup_grid<true>), one launch a warm program: the stream
            # phase's warm_start and fused_pair windows started from the
            # previous window's mapped state.
            "kernels": ["setup_rows", "setup_grid"],
            "launches": sum(c["setup_warm_launches"] for c in launches.values()),
            "max_abs_err": 0.0,
            # One launch at the 10M-span window's set-up shape (the grid
            # form), beside the config-5 kind window's (a block a row);
            # cold_ms the cold set-up in turns. No single PyTorch call
            # computes the set-up: library_ms null.
            **({} if k19["giant_10m"] is None else {
                key: k19["giant_10m"][key] for key in ("ms", "cold_ms", "plain_ms",
                                                       "bound_ms", "form")}),
            "ms_config5_kind": k19["config5_kind"]["ms"],
            "cold_ms_config5_kind": k19["config5_kind"]["cold_ms"],
            "plain_ms_config5_kind": k19["config5_kind"]["plain_ms"],
            "bound_ms_config5_kind": k19["config5_kind"]["bound_ms"],
            **({"ms": k19["config5_kind"]["ms"], "plain_ms": k19["config5_kind"]["plain_ms"],
                "bound_ms": k19["config5_kind"]["bound_ms"]} if k19["giant_10m"] is None
               else {}),
            "bound_by": (k19["giant_10m"] or k19["config5_kind"])["bound_by"],
            "library_ms": None,
        },
        {
            "name": "rank_epilogue",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/rank_epilogue.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:882",
            # One launch a program (a block, or a cluster, a window of a
            # stacked group): jax_tpu.py:882 _partition_finish, :971
            # spectrum_counters, :1006 window_spectrum, :1046
            # top_k_tiebroken, :1068 _finish_topk. epilogue_window; the
            # first design (epilogue_first) timed in turns.
            "kernels": ["epilogue_window"],
            "launches": sum(c["epilogue_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("epilogue_launches"),
            "max_abs_err": 0.0,
            # One launch at the config-5 kind window (3,072 ops; the
            # 10M-span window's 2,048 in _giant_10m); library_ms is the
            # top-k alone, one stable torch.sort of the negated scores
            # (no PyTorch call computes the finish and the spectrum).
            "ms": k6_c5["epilogue"]["ms"],
            "first_design_ms": k6_c5["epilogue"]["first_design_ms"],
            "ms_giant_10m": k6["epilogue"]["ms"],
            "first_design_ms_giant_10m": k6["epilogue"]["first_design_ms"],
            "form": f'{k6_c5["epilogue"]["plan"]["form"]}/{k6_c5["epilogue"]["plan"]["select"]}',
            "host_issue_ms": k6_c5["epilogue"]["host_issue_ms"],
            "plain_ms": k6_c5["epilogue"]["plain_ms"],
            "plain_ms_giant_10m": k6["epilogue"]["plain_ms"],
            "bound_ms": k6_c5["epilogue"]["bound_ms"],
            "bound_by": k6_c5["epilogue"]["bound_by"],
            "library_ms": k6_c5["epilogue"]["library_ms"],
            # K14: the launch with its check word (the ranking and the
            # residual trace checked) and without, in turns at the
            # config-5 kind window.
            "check_word_ms": families["checks"]["epilogue_ms"],
            # At k = V (the k13 phase's one-formula launch, V 3,072): the
            # sort and, in turns, the radix select.
            "ms_k_v": k13["config5_kind"]["k_v"]["one_launch_ms"],
            "previous_selection_ms_k_v":
                k13["config5_kind"]["k_v"]["one_launch_previous_selection_ms"],
        },
        {
            "name": "rank_epilogue_all_methods",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/rank_epilogue.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:1373",
            # K13: the epilogue with a methods axis (grid y, 13 rows;
            # epilogue_window<C, true>), one launch an all-methods program:
            # the eval phase's evaluate_all_methods runs on the card (one
            # a detected case).
            "kernels": ["epilogue_window"],
            "launches": sum(c["epilogue_all_methods_launches"] for c in launches.values()),
            "max_abs_err": 0.0,
            # One launch at the config-5 kind window (V 3,072) at k = V,
            # what the harness ranks (_k_n_rows: k = 11; _giant_10m: the
            # 10M-span window's V 2,048, k = V); thirteen_launches_ms the
            # 13 one-formula launches it replaces, in turns; library_ms
            # the top-k alone, one stable torch.sort of the [13, V]
            # negated scores.
            "ms": k13["config5_kind"]["k_v"]["ms"],
            # previous_selection_ms: the radix select in turns;
            # sort_share: the selection sweep's.
            "previous_selection_ms": k13["config5_kind"]["k_v"]["previous_selection_ms"],
            "sort_share_measured": k13["config5_kind"]["sweep"]["sort_share_measured"],
            "plan_sort_share": k13["config5_kind"]["sweep"]["plan_sort_share"],
            "thirteen_launches_ms": k13["config5_kind"]["k_v"]["thirteen_launches_ms"],
            "one_launch_ms": k13["config5_kind"]["k_v"]["one_launch_ms"],
            "ms_k_n_rows": k13["config5_kind"]["k_n_rows"]["ms"],
            "thirteen_launches_ms_k_n_rows":
                k13["config5_kind"]["k_n_rows"]["thirteen_launches_ms"],
            **({} if k13["giant_10m"] is None else {
                "ms_giant_10m": k13["giant_10m"]["k_v"]["ms"],
                "thirteen_launches_ms_giant_10m":
                    k13["giant_10m"]["k_v"]["thirteen_launches_ms"],
            }),
            "plain_ms": k13["config5_kind"]["k_v"]["plain_ms"],
            "bound_ms": k13["config5_kind"]["k_v"]["bound_ms"],
            "bound_by": k13["config5_kind"]["k_v"]["bound_by"],
            "library_ms": k13["config5_kind"]["k_v"]["library_ms"],
        },
        {
            "name": "explain_epilogue",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/explain_epilogue.cu",
            "replaces": "microrank_tpu/explain/extract.py:212",
            # K15: the explained program's attribution epilogue
            # (extract.py:59 _slot_map, :74 _contrib_rows, :172
            # _top_traces, and :212's gathers; its blob twin :277), one
            # call an explained program: the route's fill (explain_cols
            # or explain_sparse), then explain_merge passes
            # (kernel_launches). The main path's calls: the
            # incident the explain phase's stream run opened.
            "kernels": ["explain_cols", "explain_sparse", "explain_merge"],
            "launches": sum(c["explain_launches"] for c in launches.values()),
            "kernel_launches": sum(c["explain_kernel_launches"] for c in launches.values()),
            "max_abs_err": 0.0,
            # One call at the config-5 kind window (Ke 11, J 5), the
            # route the stream's incident took; _by_route every config-5
            # route's window and the giant windows'. library_ms is the
            # selection alone: one stable torch.sort of the [2, Ke, T]
            # contribution rows. The bound: the bytes the function reads
            # and writes (ops' k15_bytes) at 3.35 TB/s.
            "ms": k15s["kind"]["ms"],
            "plain_ms": k15s["kind"]["plain_ms"],
            "bound_ms": k15s["kind"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": k15s["kind"]["library_ms"],
            **{f"{key}_by_route": {label: m[key] for label, m in k15s.items()}
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            # The explained program against the one-formula program at
            # the config-5 kind window, in turns.
            "explained_program_ms": explained["program_ms"]["explained"],
            "one_formula_program_ms": explained["program_ms"]["one_formula"],
        },
        *(
            {
                "name": "dense_matvec" if precision == "f32" else "dense_matvec_bf16",
                "route": "cuda",
                "source": "microrank_tpu_torch/csrc/dense_mv.cu",
                "replaces": "microrank_tpu/rank_backends/jax_tpu.py:361",
                "precision": precision,
                # Every counted main path's launches (one a step: the six
                # products of both partitions, a stacked group's every
                # window).
                "launches": sum(c["dense_launches"] for k, c in launches.items()
                                if k.startswith((f"families/{kernel}/",
                                                 f"families/stacked/{kernel}/"))),
                "max_abs_err": 0.0,
                # One step at the uncollapsed config-5 window (the dense
                # matrices in the gigabytes; _collapsed: the collapsed
                # window's); library_ms is six torch.mv over the same
                # matrices (bf16: over the bf16 ones, the vector cast,
                # bf16 out).
                "ms": families["runs"][f"{kernel}/off"]["dense"]["ms"],
                "ms_collapsed": families["runs"][f"{kernel}/auto"]["dense"]["ms"],
                "plain_ms": families["runs"][f"{kernel}/off"]["dense"]["plain_ms"],
                "bound_ms": families["runs"][f"{kernel}/off"]["dense"]["bound_ms"],
                "bound_ms_collapsed": families["runs"][f"{kernel}/auto"]["dense"]["bound_ms"],
                "bound_by": families["runs"][f"{kernel}/off"]["dense"]["bound_by"],
                "library_ms": families["runs"][f"{kernel}/off"]["dense"]["library_ms"],
            }
            for kernel, precision in (("dense", "f32"), ("dense_bf16", "bf16"))
        ),
        {
            "name": "row_fold",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/row_fold.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:44",
            # Off the main path since K6's two kernels (its tree runs
            # inside both): 0 launches in every counted main path; kept
            # as the tree's standalone yardstick, timed below.
            "launches": sum(c["row_fold_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("row_fold_launches"),
            "max_abs_err": max(row_fold["max_abs_err"], steps["fold"]["max_abs_err"]),
            # One launch of two rows at the 10M-span window's set-up
            # shape (_config5: the uncollapsed config-5 window's);
            # library_ms is one torch.sum over the live columns (its
            # own order).
            "ms": row_fold["ms"],
            "ms_config5": steps["fold"]["ms"],
            "plain_ms": row_fold["plain_ms"],
            "bound_ms": row_fold["bound_ms"],
            "bound_by": row_fold["bound_by"],
            "library_ms": row_fold["library_ms"],
        },
    ]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
