#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, and its reproduction
chain of CLIs, on one CUDA card and check them.

    python3 chip_smoke.py [--quality]

Phases, in order (any failure raises and the script exits non-zero):

1. Device: the card's name, ``nvidia-smi`` name and power limit.
2. Build: compile ``ionic_mpnn_torch/csrc`` with nvcc (one process per
   source) and print the build time, each kernel's registers and spills
   (the general fused kernel and its prologue must spill nothing), and,
   where the toolkit has ``cuobjdump``, each fused product kernel's count
   of HMMA (tensor-core) instructions; every one must have some.
3. Kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at the cation and anion shapes of a batch-2048 bench batch with
   h in f32 and in bf16, and on hard cases (nodes with no in-edges, one node
   with in-degree >= 3000, an edge with |src - dst| >= 256, N not a multiple
   of 32); then graphs whose 16-node tiles hold every bond type (V = 7, and
   V = 32, the most any width takes), two launches on the same input giving
   the same bits, the kernels and their plain versions against an f64
   evaluation, and inputs the wrappers refuse (D = 20 and D = 136, 33 types
   at D = 128 and at D = 32, a float16 h, a strided input, a table on the
   CPU; none may launch a kernel). Tolerance: f32 rtol 1e-5 /
   atol 1e-5 (the order of summation and the f32-accurate tensor-core
   products differ), bf16 inputs 1e-3. The hard cases use dyadic values, so every summation order is exact
   and the tolerance only absorbs exp/tanh/rsqrt.
4. Backward vs plain: the backward's ``dh`` launch (the fused-message kernel
   on the cotangent and the transposed table) against the plain version at
   the cation and anion shapes and on a reversal-closed hard case (a hub of
   in- and out-degree 3100, empty rows, |src - dst| up to 999), at f32 1e-5.
   Then the full gradients of the three autograd Functions
   (``FusedMessageAggregate``: dh, dm_table; ``FusedMPStep``: dh, dm_table,
   dgru; ``SortedSegmentSum``: dmsg) against torch autograd of each plain
   forward on the card, at rtol/atol 1e-4; the two dm_table (the table
   gradient's kernel) against autograd of the same forward in f64, where
   the f32 plain version's own error passes 1e-4 (logged beside).
   [widths]: the fused kernels at the widths the general kernel serves,
   D = 8, 16, 48, 64 and 128 (D = 32 is the specialisation of phases 3-4),
   in each of its two designs, forced in turn (``DESIGNS``: the 64-row
   blocks and the warp teams; the library chooses by D, node count and
   kernel). At each: forward, ``dh`` and step against their plain versions
   at the cation and anion shapes (V = 7) and on a graph whose tiles hold
   all 32 bond types, h in f32 (1e-5) and bf16 (1e-3); at D = 64 and 128
   the three Functions' gradients against plain autograd at 1e-4 (weights
   scaled by fan-in, 0.2 at D = 32), at D = 128 two launches bit-equal.
   Each kernel's device time per call at D = 8 to 128 in each design (a
   CUDA graph of 20 calls timed with events; D = 32 too, for comparison)
   beside its plain version's and its bound (the log adds the earlier
   release's time, ``EARLIER_MS``); at D = 64 and 128 the anion shape's
   times in both designs and the blocks' prologue (its planes bit for bit
   against the plain split, its time and bound). At every width, 8 to 128
   with 32, the backward's table gradient ``dK`` (``csrc/table_grad.cu``)
   on the cation, anion and V = 32 graphs, h f32 and bf16: against its
   plain version (PyTorch ops) within 1e-5 of the table's largest entry,
   two launches bit-equal, its plan (held to ``TABLE_GRAD_PLANS``, the
   plans the tests' mirror of the kernel's order takes), and its time
   beside the plain version's and its bound. Then the paths that run
   these widths with the card's default configuration (``message_impl`` "auto": ``pallas_step``
   bf16): JAX's D-scaling arm at atom_dim 64 and 128 (fp_size = D, mixing
   max(20, D // 2), batch 2048, 4 message steps) — one train step against
   plain ``gather`` f32 with the same bf16-rounded weights (phase 6's
   tolerances) and ``bench_packed_train_step``'s message-edges/s, launches
   exact, the launches that ran the blocks counted per kernel — and
   ``train_melting_point --atom-dim 64`` for 2 epochs in a process of its
   own as phase 12 runs the CLIs, launches exact (its batches take the
   teams).
5. Main path (serving): the viscosity model at full width (atom_dim 32,
   bond_dim 8, fp 32, mixing 20, 4 message steps) with seeded random
   weights, serving 3 batches of 2048 records through ``predict`` in five
   kernel configurations, each held against a plain configuration on the
   card with the same weights at rtol 1e-4 / atol 1e-4: plain ``gather`` f32,
   for ``pallas_step`` bf16 with the three tensors that configuration rounds
   to bf16 rounded the same way, and for ``pallas_fused`` bf16 plain
   ``gather`` bf16 at 2e-2 (bf16 GatedUpdate matmuls round an aggregate that
   was summed in another order). Launch counters are zeroed before each
   configuration and must read exactly 8 per forward for its kernel, 0 for
   the others.
6. Train path: the same model and weights, 3 train steps (forward, masked
   MSE + L2, backward through the kernels' autograd Functions, per-tensor
   clip, Adam) on the same 3 batches in five kernel configurations and
   three plain ones. Every parameter's first gradient is present and
   finite; the gradients and the three losses match the plain arm with the
   same roundings (f32: gradients 1e-3 of each tensor's scale, losses rtol
   1e-4 then 1e-3; bf16: 2e-2); the launch counters read exactly, per step,
   8 ``fused_mp_step`` + 16 ``fused_message_aggregate`` (8 remat, 8 dh) for
   ``pallas_step``, 16 ``fused_message_aggregate`` (8 forward, 8 dh) for
   ``pallas_fused``, 8 ``fused_message_table_grad`` (dK) in both, 8
   ``sorted_segment_sum`` for the pallas scatter.
   On CUDA every train step, dev eval and ``predict`` forward of these
   phases and the later ones runs as a replayed CUDA graph (the port's
   default); each graph's kernel launches count once per replay (the
   counts its capture recorded), so every exact count below counts the
   kernels the card ran.
7. fit(): the viscosity model at full width, batch 32, on 3,200 bench
   records whose targets are a seed-1 teacher's predictions on the card,
   split 2560 / 320 / 320 by ``random_split``, from the same weights. Under
   deterministic algorithms: plain ``gather`` f32 (2 epochs), the same
   from weights one f32 rounding up (2), ``pallas_step`` f32 (4, a
   checkpoint every epoch), and the same stopped at epoch 2 and resumed to
   4 from its checkpoints: the resumed run equals the uninterrupted one bit
   for bit (history and best weights); the trajectories' gaps to plain are
   printed (the one-rounding run shows how far rounding alone moves them).
   Then 2 epochs of ``pallas_step`` f32 in lockstep with plain ``gather``
   on the same parameters, also under deterministic algorithms (so its
   trajectory, and a failure, repeat bit for bit): every forward's
   predictions at rtol/atol 1e-4 and every train step's gradients at 1e-3
   of |want| + max|want| (phase 6's bound), before the update; a failure
   names the train step and the parameter of the worst gradient. Then, as
   users run it, the default-resolved configuration (``pallas_step`` bf16,
   4 epochs: the last epoch's loss below half the first's;
   ``evaluate_splits`` finite and equal to the metrics of ``predict``) and
   ``gather`` with the pallas scatter (1). Over each whole ``fit()`` the
   launch counts are exact: train steps × the per-step counts of phase 6
   plus dev batches × epochs × 8 for the forward's kernel. Per epoch it
   prints the seconds of ``dispatch``, ``fetch+eval(sync)`` and
   ``host_reduce``; per run the median epoch time and train steps/s.
   [graphs], under deterministic algorithms: per arm (``pallas_step`` f32
   and bf16, ``pallas_fused`` f32, ``gather`` with the pallas scatter,
   plain ``gather`` f32, onehot f32 on aligned batches) the same 8 train
   steps at batch 512 (groups of 3, 3 and a remainder of 2) eagerly, as
   one-step graph replays and through the K = 3 graph: losses, parameters,
   both moments and the update count equal bit for bit, launches exact.
   ``fit()`` of ``pallas_step`` f32 (2 epochs) with K = 8, K = 1 and eager:
   histories and best weights equal bit for bit. The transfer model's
   stage 2 with dropout 0.3: four steps draw four different masks, and two
   graphed fits from one seed are equal. Times, graphed against eager, in
   this call: the K = 8 ``pallas_step`` bf16 step at batch 2048 (wall, host,
   busy, idle share, message-edges/s, peak memory), ``predict``'s forward
   per batch, and the default configuration's ``fit()`` epochs. Last, after
   phase 13, the profiler: our kernels in one replayed group against the
   capture's count, and the steps' busy time.
   [native]: the port's C++ packer builds with g++; its batches equal the
   Python packer's array for array in the sorted, window, window_aligned
   and balanced layouts; ``fit()`` with it equals ``fit()`` with the Python
   packer bit for bit with K = 8 (group mode) and K = 1; the dispatch
   seconds of each.
8. Melting-point model at full width (bond_dim 1024): ``predict`` over the
   3 bench batches in ``pallas_step`` f32 against plain ``gather`` f32 at
   rtol/atol 1e-4 with 8 launches per forward, then 2 epochs of
   ``fit(normalize_y=True)`` on a teacher's targets, its normalizer fitted
   on the train split only.
9. Bench: ``python -m ionic_mpnn_torch.bench --repeats 1`` in a process of
   its own exits 0 and prints the training metric, finite and positive, on
   the host harness with ``vs_baseline`` (the dense reference baseline in a
   process of its own) and the H100 roofline's ``mfu`` (at most 1) and
   ``hbm_bound_fraction``; then with ``--message-impl onehot --no-baseline``,
   which must run the paired harness.
10. One-hot: the JAX package's accelerator default, ``message_impl=
   "onehot"`` on ``window_aligned`` batches (``edge_layout_for``; window
   from ``resolve_onehot_window``: 128 for f32, 64 for bf16), and the other
   window layouts, on the 6,144 bench records. Per plan: batches, and per
   side N, E, windows, tile and tile fill. The three CUDA kernels against
   their plain versions on an aligned cation batch (window pads: masked
   self-loops on each window's last node). ``predict`` in onehot f32 with
   each select (vloop, lanes, basis), bf16, on ``window`` (halo) and on
   balanced batches, and ``pallas_step`` f32 and bf16 on aligned batches,
   each against plain ``gather`` on the same batches and weights (1e-4;
   onehot bf16 at 2e-2 against plain ``gather`` bf16 rounding the bond-type
   table and the messages to bf16 where onehot does; ``pallas_step`` bf16
   against f32 with its rounded tensors, as in phase 5; the plain
   references under deterministic algorithms); plain ``gather`` on aligned
   batches against sorted ones per record at 1e-5. Launches: none in the onehot arms, exactly 8
   ``fused_mp_step`` per forward in ``pallas_step``'s. Then 3 train steps
   per arm against its plain arm (phase 6's tolerances and launch counts;
   ``remat_message``'s first gradients against the same arm without it at
   1e-5), and ``fit()`` of onehot f32 for 2 epochs at batch 32 on phase 7's
   teacher records with an aligned plan and the host loader
   (``device_epochs=False``), twice under deterministic
   algorithms: the histories and best weights equal bit for bit, the loss
   falls. Last, with CUDA events, forward and train-step wall and host
   times of onehot f32, onehot bf16 and ``pallas_step`` bf16 on aligned
   batches, with message-edges/s and peak memory; their profiler readings
   (busy time, idle share, top kernels; a session each) and pallas_step's
   fused-kernel device time per forward on aligned against sorted batches
   come last, after phase 13.
   [device_epochs]: device-resident epochs (``training/device_epochs.py``,
   ``fit()``'s default on CUDA for onehot), window 64. On the 6,144 bench
   records at batch 2048: a plain batch (with sentinel slots) and a paired
   one packed on the card equal the same functions on the CPU array for
   array; one paired onehot f32 step against plain ``gather`` f32 on the
   host-packed same records (first gradients and loss, phase 6's f32
   bounds). Under deterministic algorithms, on phase 7's 2,560 train
   records at batch 256 in f32 and bf16: a paired epoch replayed through
   the K = 8 graph and the one-step graph equals the same steps run
   eagerly, and with an extra empty step appended, bit for bit (losses,
   parameters, both moments, the update count); a device-epoch ``fit()``
   (onehot bf16, batch 32, paired) resumed at epoch 2 equals the
   uninterrupted one. Then ``fit()`` at phase 7's recipe in onehot bf16 with
   device epochs paired, unpaired and off (the graphed native loader):
   steady epoch seconds; and the paired bench step at batch 2048 (onehot
   bf16, K = 8, 16,384 records): ms per step, message-edges/s, the pack
   alone per step, cation and anion windows per step against the host
   plan's, peak memory; its profiler busy share last, after phase 13. No
   CUDA kernel launches in the phase (onehot has none).
11. Transfer: the transfer model at full width (phase 5's viscosity trunk
   and weights, head 256/128/64, dropout 0) on the three bench batches
   planned without temperature, with a seed-1 teacher's melting points.
   ``predict`` in ``pallas_step`` f32 against plain ``gather`` f32 in eval
   mode (rtol/atol 1e-4, 8 ``fused_mp_step`` per forward); then one
   stage-1 (head only) and one stage-2 (plus steps 2-3 and the mixing
   projections) train step on both from the same weights: losses and
   gradients within phase 6's f32 bounds, every frozen tensor bit for bit
   unchanged, the BatchNorm running statistics at 1e-4, and exactly 8
   ``fused_mp_step`` and 0 ``fused_message_aggregate`` in stage 1, 8 and 6
   (2 of them ``dh``) in stage 2.
12. Chain: the reproduction path as users run it, each CLI a process of
   its own (``python -m ionic_mpnn_torch.cli.*``, no JAX) in a temporary
   directory: ``prepare_data --synthetic`` at the reference scale (7,666
   viscosity rows, 400 melting-point draws); ``train_viscosity`` beside
   ``train_melting_point``, 2 epochs each; ``train_transfer`` (on
   train_viscosity's checkpoint, 2 epochs) beside ``screen`` on that
   checkpoint in candidate mode and with ``--grid-cations`` (the
   brute-force device sweep); then ``evaluate``. The CLIs of a wave run side
   by side, as a user with one card may run them, and the chain runs after
   [screen], beside [dp]'s gloo ranks, as do [protocols] and [dryrun]. Each exits 0, writes
   its files and reports CUDA kernel launches; ``evaluate`` repeats each
   training CLI's R² and MAE. Per CLI its seconds (beside the others of its
   wave) and R² lines, and per transfer stage its epoch seconds and train
   steps/s.
   [screen]: screening (``ionic_mpnn_torch/inference.py``) at the
   viscosity model's published width with seeded random weights, batch
   2048, ``pallas_step`` in the card's default compute dtype, on the
   screening library (all 2,688 enumerated cations, the 25 screening
   anions; a vocab built from it, so only perchlorate, which the built-in
   parser refuses, is skipped). A batch packed on the card
   (``ops/grid_pack.py``) equals the native packer's on its real nodes and
   edges, and the two forwards agree (f32 at 1e-4, bf16 at 2e-2). On a
   50,400-candidate sub-grid, top 100: the device and host sweeps,
   ``pallas_step`` f32 against plain ``gather`` f32, and the factorized
   sweep against the brute force agree at 1e-4 on every shared candidate and
   differ in their sets only by candidates within 1e-4 of the k-th score
   (the readout's atomic sums move the last bits between two runs); so do
   the factorized sweep in the default dtype and a brute-force sweep of its
   own formulation (``gather``). Short sweeps in ``pallas_fused`` and ``gather`` with the
   pallas scatter against plain. Every sweep's launches are exact (8 per
   batch, K = 8 batches per graph replay). Then the BASELINE config-5 sweep,
   2,688 × 24 × 156 = 10,063,872 candidates, brute force on the card: pairs/s
   overall and steady, replays, peak memory; per batch inside it the replay
   / K, the pack alone and the forward alone; the host path on 193,536
   candidates (pairs/s, the producer wait); the factorized sweep over the
   10M grid (seconds). Its profiler reading (busy share over a few
   replays) comes last, after phase 13.
   [dp]: the data-parallel tier (``ionic_mpnn_torch/parallel``) in ranks
   that ``run_local`` spawns after the build (each loads the built
   library). NCCL over every card (one rank on one card): ``pallas_step``
   bf16, batch 2048 per rank, K = 8 on [graphs]' 8 packings of the bench
   batch, under deterministic algorithms: the K-step DP graph (two calls:
   capture, then replay) equals the eager DP step and, at one rank, the
   single-device step, bit for bit over 16 steps (losses, parameters, both
   moments, the count), launches exact; the DP step's and the
   single-device step's wall, host and busy ms, idle share,
   message-edges/s and the all-reduce's device time per step (profiler),
   and the all-reduce of the step's buffer alone; ``fit(mesh=)`` at
   [fit]'s recipe (2 epochs) in ``pallas_step`` bf16 on the native loader
   and onehot bf16 (window 64) on paired device epochs: resumed at epoch
   1 it equals the uninterrupted run and, at one rank, ``fit()`` without a
   mesh, bit for bit; steady epoch seconds with and without the mesh;
   ``ScreeningEngine(mesh=)``'s ``predict_batch`` against the single
   engine (1e-5). Then 2 gloo ranks on card 0 (eager by design: gloo
   cannot be captured), side by side with [ep]'s gloo ranks, f32, ``pallas_step`` and ``gather`` with the
   pallas scatter: 2 steps each, the parameters within 1e-5 of each
   tensor's max of the accumulated single-process reference, the ranks
   bit-equal, launches exact, the steady step's wall ms (a record); a
   one-epoch ``fit(mesh=)`` of 512 records whose ranks end bit-equal; the
   fan-out over 2 ranks. A failed rank stops the others and raises.
   [ep]: the model-parallel tier (``parallel/edge_partition.py``,
   ``halo_partition.py``, ``aligned_partition.py``, ``tensor_parallel.py``)
   at the same width, batch 2048 on [graphs]' packings of the bench batch,
   under deterministic algorithms, in spawned ranks. NCCL over every card
   (one rank on one card): EP v1 (edges sharded, nodes replicated) in
   ``pallas_fused`` f32 and bf16 and ``gather`` with the pallas scatter,
   each kernel launched on the rank's edge shard: the K = 4 EP graph (two
   calls) equals the eager EP step and, at one rank, the single-device
   step, bit for bit over 8 steps (on several cards, within the bound
   below), launches exact; the EP step's wall, host and busy ms, idle
   share, message-edges/s and its all-reduces' device time per step. Its
   gloo ranks ran earlier, beside [dp]'s (nothing there is timed for a
   comparison): 2 gloo ranks on card 0 (eager): EP v1 in both kernel configurations
   (f32), halo exchange (gather f32), aligned EP (onehot bf16, window 64)
   and tensor parallelism (``model_parallel=2``, ``pallas_fused`` f32); and
   4 gloo ranks: DP×EP (2 × 2, aligned onehot bf16). Each gloo arm takes 2
   steps, the first tallied (each collective's kind and bytes): the
   parameters within (rtol, atol) (2e-3, 3e-6) in f32 (JAX's EP oracle's)
   and (2e-2, 4e-3) in bf16 of the single-process reference on the card
   (one step over the same batch, or over the DP groups' batches
   accumulated), the ranks bit-equal, the launches per rank exact. Last,
   ``benchmarks/scaling.py`` in its three modes over the cards the machine
   has (on one card one step, beside [dp]'s gloo ranks). A failed rank
   stops the others and raises.
   [phases]: the phase-cut forward (``benchmarks/phases.py``) of the
   onehot model on the bench batch of 2048 (window_aligned, window 64),
   in bf16 and f32: every phase finite, ``fwd`` equal to the model's loss
   (bf16 3e-2, f32 1e-5), each phase's forward time (CUDA events, median
   of 20) and the deltas between phases. Then, in a process of its own
   (the profiler stays attached to a process once it ran), ``utils.trace``
   around two graphed ``pallas_step`` bf16 train steps: the trace file
   exists and names ``fused_message_tc_kernel``; launches exact.
   [protocols] (beside [dp]'s gloo ranks): the quality-protocol CLI
   (``python -m ionic_mpnn_torch.cli.quality_protocols``) as an entry
   point, in a process of its own with JAX, its libraries, the JAX package and
   matplotlib unimportable: the published data (hard labels from 7,666
   viscosity rows and 400 melting-point draws), the random, pair-level and
   family-holdout splits and all three tasks, seed 0, batch 1024, in the
   default CUDA configuration (``pallas_step`` bf16), the viscosity model
   from the JAX protocol's seed-0 weights (``tools/quality_init_seed0.npz``,
   ``--init-from``) under deterministic algorithms (``--deterministic``),
   each fit cut to 2 epochs. Each row beside the JAX package's row of the
   same task and split (``docs/quality_protocols_r5.json``); the split
   sizes equal JAX's, every metric finite, the launch counts exact (from
   each fit's train steps, epochs and dev batches and the evaluation's
   batches, as the CLI reports them: phase 6's per-step counts,
   [transfer]'s per stage, 8 ``fused_mp_step`` per forward), no
   ``sorted_segment_sum``.
   ``python3 chip_smoke.py --quality`` runs, in its place, [quality]: the
   same battery at the published depth (viscosity up to 400 epochs with
   warm-up 1000, the melting-point model and the two-stage transfer up to
   300, patience 50) with the same checks, and the random split's test R²
   at least 0.50 (viscosity), 0.85 (mp) and 0.85 (transfer); a row below
   its gate runs again in plain ``gather`` f32 on the card, both rows
   printed, and the phase fails. Its viscosity gate is missed (PERF.md §6,
   PR 13), so it stays out of the default run until its premise is set.
   [dryrun] (beside [dp]'s gloo ranks): the driver's entry points
   (``ionic_mpnn_torch/dryrun.py``, the JAX package's
   ``__graft_entry__.py``). ``entry()`` on the card
   (``pallas_step`` bf16, the resolved configuration, 8 records at full
   width) against plain ``gather`` f32 reading the bf16-rounded tensors at
   [main]'s tolerance, 8 ``fused_mp_step``; then ``dryrun_multichip`` on
   one NCCL rank per card and on 2 gloo ranks on card 0, every arm of the
   JAX dry run (the DP step in ``pallas_step`` f32; onehot DP; TP at width
   16 in ``gather``; the EP aggregate; halo in f32 ``gather``; aligned EP;
   DP×EP; DP device epochs; sharded screening; the sharded eval, whose rows
   equal the single-device forward of each shard; the checkpoint resume
   under the mesh), each rank's launches per arm exact.
   [demo]: the port's notebook (``examples/demo_torch.ipynb``) at its own
   sizes (2,000 viscosity rows, 300 melting-point draws, up to 120 epochs
   with patience 30 at batch 32, transfer up to 80 with patience 20, the
   screening top 10 of 200 candidates), its code cells run in order in one
   namespace in a temporary directory on the card's default configuration
   (``pallas_step`` bf16): each cell's seconds, the viscosity model's
   Train/Dev/Test R² and MAE and the Dev R² of the melting-point and
   transfer models beside the JAX notebook's outputs (no gate: draws of the
   recipe), the launches exact from what the fits report.
   [host_pipeline]: ``python -m ionic_mpnn_torch.benchmarks.host_pipeline``
   at its defaults (100,000 records, batch 2048, K = 8, onehot's aligned
   layout): the seconds of each host stage of a ``fit()`` epoch, the
   copies going to the card.
   [bisect]: ``cli/quality_bisect.py`` at its default size (1,500 records,
   the five arms), its depth cut from 60 epochs to ``BISECT_EPOCHS``: each
   arm's line; no kernel launched.
13. Times. Wall times first (CUDA events, before torch.profiler attaches):
   each wrapper call at the cation shape (median of 60), each forward per
   batch (median of 50), the host time each kernel's autograd Function would
   add to a launch in inference mode (the wrapper's direct launch and the
   Function alternated, medians of 60) and each train step (median of 20 after 3
   warm-up steps, with message-edges/s over the 20). Then the card's own records through
   torch.profiler: each kernel's time (mean of 60 launches), the plain
   version's and the one-call PyTorch yardstick's device time (the table
   gradient: its two kernels, each and together, held to its plain version
   and bit-equal on two launches), and per forward and per train step the busy
   time, the share of the wall time in which the card ran nothing, and the
   top kernels. Bounds are the least time the card could take (published
   H100 SXM peaks: 3.35 TB/s; the fused kernels' f32-accurate products over
   the TF32 tensor-core rate / 3, the rest over the f32 CUDA-core rate),
   with the operations this run's data needs: the typed buckets' products
   count 2 D² for each (node, bond type) pair that holds a real edge
   (``bucket_pairs``), their sums one add an element of a real edge.
   Then one epoch of the default configuration's ``fit()`` under the
   profiler: the card's busy time and its share of the epoch.

Output: one ``{"kernels": [...]}`` JSON line (the rows of D = 64 and 128
that the paths launched, per design, the prologue and ``dK``, from [widths],
beside the model's D = 32; every width's times under
``"widths"``), then the last line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, no tensor cores
TF32_FLOPS = 495e12  # tensor cores, dense TF32; an f32-accurate product takes three passes
BATCH = 2048
N_BATCHES = 3
F32_TOL = 1e-5
BF16_TOL = 1e-3
MODEL_TOL = (1e-4, 1e-4)  # rtol, atol of a 4-step forward against its plain path
BF16_MODEL_TOL = (2e-2, 2e-2)  # bf16 GatedUpdate: the CPU tests' bf16 tolerance
GRAD_TOL = 1e-4  # rtol and atol of a Function's gradients against plain autograd
# train step against its plain arm: gradients |err| <= tol·|want| + tol·max|want|
# per tensor (a backward through 4 message steps over 2048 pairs, with sums of
# up to 1.2e5 edge terms in other orders: 5x the CPU tests' 2e-4 at 2 steps and
# 16 pairs); losses rtol 1e-4 at step 1 and 1e-3 after it (Adam's first updates
# are about lr·sign(g), so gradient entries at rounding noise can move a few
# parameters by up to 2·lr in one arm only); bf16 arms 2e-2 throughout.
TRAIN_TOL = {"float32": (1e-3, (1e-4, 1e-3, 1e-3)), "bfloat16": (2e-2, (2e-2,) * 3)}
TIMED_LAUNCHES = 60
TRAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def mark(phase: str) -> None:
    """One line on standard error as each phase ends, with the seconds
    since the start: where a run that was stopped got to."""
    print(f"[progress] {phase} ended at {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr, flush=True)


def run_together(calls):
    """Run each of ``calls`` (name -> function of no arguments) in a thread
    of its own and return ``{name: (value, seconds)}`` once all have
    ended; the first error raises then. For work that waits on processes
    of its own (``run_local`` ranks, CLI processes) and times nothing
    that the others would disturb."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        value = fn()
        return value, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(calls)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in calls.items()}
    return {name: f.result() for name, f in futures.items()}


def close(name, got, want, rtol, atol):
    got = got.float()
    want = want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    excess = err - (atol + rtol * want.abs())
    if excess.max().item() > 0:
        i = int(excess.argmax())
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} beyond rtol {rtol} atol {atol}"
            f" (flat index {i}: got {got.flatten()[i].item()!r}, want "
            f"{want.flatten()[i].item()!r})")
    return err.max().item()


def time_ms(fn, n=TIMED_LAUNCHES):
    """Median wall time of one call of ``fn`` as the caller sees it (CUDA
    events around each call, host work included)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def function_overhead(direct, wrapped, n=TIMED_LAUNCHES):
    """A kernel's wrapper with no gradient to record (it launches directly)
    against the same launch through its autograd Function, alternately so
    that drift hits both alike:
    medians of the host time of a call (clock at its return, the card idle
    before it) and of its CUDA-event call time."""
    times = {f"{k}_{m}": [] for k in ("direct", "function") for m in ("host_ms", "call_ms")}
    for _ in range(5):
        direct()
        wrapped()
    for _ in range(n):
        for key, fn in (("direct", direct), ("function", wrapped)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            t0 = time.perf_counter()
            fn()
            times[f"{key}_host_ms"].append(1e3 * (time.perf_counter() - t0))
            b.record()
            b.synchronize()
            times[f"{key}_call_ms"].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def device_profile(fn, n=TIMED_LAUNCHES, warmup=5):
    """Device time of ``fn`` per call, from the card's own kernel records
    (torch.profiler / CUPTI): ``{"device_ms", "busy_ms", "by_kernel"}``.
    ``device_ms`` sums every kernel and copy the call runs; ``busy_ms`` is
    the union of their spans."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_kernel = [], {}
    for e in prof.events():
        # user annotations (the optimizer's record_function range) are spans
        # on the device timeline, not work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (end - start) / 1e3 / n
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy, last = 0.0, -1.0
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return {"device_ms": sum(by_kernel.values()), "busy_ms": busy / 1e3 / n,
            "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


# ---------------------------------------------------------------- phase 1

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    import ionic_mpnn_torch

    if Path(ionic_mpnn_torch.__file__).resolve().parent.parent != HERE:
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


# ---------------------------------------------------------------- phase 2

def phase_build():
    from ionic_mpnn_torch.ops.cuda import _lib

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    build_log = so.parent / _lib.BUILD_LOG
    if build_log.exists():
        kernel, spilled = None, []
        for line in build_log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            if "registers" in line or "spill" in line:
                log(f"[build] {kernel}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and any(k in (kernel or "") for k in GENERAL_KERNELS) and (
                    int(m.group(1)) or int(m.group(2))):
                spilled.append(f"{kernel}: {line.strip()}")
        if spilled:
            raise AssertionError("the general fused kernels spill:\n" + "\n".join(spilled))
    tensor_core_sass(so)


# the 64-row blocks of every width but 32 and their prologue, and the table
# gradient's two kernels, which must not spill (the warp teams, the earlier
# design kept for small grids and D < 64, spill as they did: [build] prints
# their lines)
GENERAL_KERNELS = ("fused_message_gen_kernel", "fused_message_split_kernel",
                   "table_grad_bucket_kernel", "table_grad_sum_kernel")
# the fused product kernels, which must run on the tensor cores (the
# prologue only splits the operands)
PRODUCT_KERNELS = ("fused_message_tc_kernel", "fused_message_gen_kernel",
                   "fused_message_team_kernel")
# the table gradient's product kernel (its sum of the parts is plain f32 adds)
TABLE_GRAD_KERNEL = "table_grad_bucket_kernel"


def tensor_core_sass(so):
    """Count each fused product kernel's and the table gradient's HMMA
    (tensor-core) instructions in the built SASS, where the toolkit has
    cuobjdump; every one must hold some."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("[build] cuobjdump not found: HMMA count not taken")
        return
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
        elif kernel and "HMMA" in line and any(
                k in kernel for k in (*PRODUCT_KERNELS, TABLE_GRAD_KERNEL)):
            counts[kernel] = counts.get(kernel, 0) + 1
    for kernel in sorted(k for k in re.findall(r"Function : (\S+)", sass)
                         if any(p in k for p in (*PRODUCT_KERNELS, TABLE_GRAD_KERNEL))):
        log(f"[build] {kernel}: {counts.get(kernel, 0)} HMMA instructions")
        if not counts.get(kernel):
            raise AssertionError(f"{kernel}: no tensor-core instruction in its SASS")


# ---------------------------------------------------------------- phase 3

def hard_case(dev, rng, V=7, D=32):
    """A graph with empty rows, a node of in-degree 3100, an edge with
    |src - dst| >= 256, N = 1001, masked pad edges with bond 0; dyadic
    values so every summation order gives the same f32 sum."""
    N = 1001
    edges = []  # (src, dst, bond, mask)
    for n in range(0, N, 7):  # a few ordinary edges; rows between stay empty
        edges.append(((n + 1) % N, n, int(rng.integers(1, V)), True))
    for k in range(3100):  # one very high in-degree node
        edges.append((int(rng.integers(0, N)), 500, int(rng.integers(0, V)), k % 5 != 0))
    edges.append((10, 900, 3, True))  # |src - dst| = 890
    edges.append((999, 0, 2, True))  # |src - dst| = 999
    for n in range(0, N, 97):  # masked pad self-loops
        edges.append((n, n, 0, False))
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    h = rng.integers(-2, 3, size=(N, D)) / 4.0
    table = rng.integers(-4, 5, size=(V, D, D)) / 16.0
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(h, torch.float32), t(table, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def typed_case(dev, rng, V, per_node, N=1001, D=32):
    """A graph in which every 16-node tile holds all V bond types: node n
    has per_node in-edges with bonds (n·per_node + k) mod V, sources spread
    over the graph, plus masked pad self-loops with bond 0; N = 1001;
    Gaussian values."""
    edges = [((n + 1 + 37 * k) % N, n, (n * per_node + k) % V, True)
             for n in range(N) for k in range(per_node)]
    edges += [(n, n, 0, False) for n in range(0, N, 13)]
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(rng.normal(size=(N, D)), torch.float32),
            t(rng.normal(size=(V, D, D)) * 0.2, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def check_repeatable(tag, h, m_table, gru, bond, src, dst, mask, N, phase="kernels"):
    """Two launches of each fused kernel on the same input give the same bits
    (one warp sums a tile in CSR order, no atomics)."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step

    K = fused_message.message_table_to_lanes(m_table)
    for name, call in (
            ("fused_message_aggregate", lambda: fused_message.fused_message_aggregate(
                h, K, bond, src, dst, mask, N)),
            ("fused_mp_step", lambda: fused_step.fused_mp_step(
                h, m_table, gru, bond, src, dst, mask, N))):
        a, b = call(), call()
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {tag}: two launches differ by "
                                 f"{(a - b).abs().max().item():.3e}")
    torch.cuda.synchronize()
    log(f"[{phase}] {tag}: two launches of each fused kernel give the same bits")


def accuracy_vs_f64(tag, h, m_table, gru, bond, src, dst, mask, N):
    """Each fused kernel and its plain version against an f64 evaluation of
    the same function: max and RMS |err|. The kernels sum the messages in
    another order (buckets per node and type, then the product), so this
    says which of the two f32 results is nearer the function."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step
    from ionic_mpnn_torch.ops.gru import gated_update

    E, D = src.shape[0], h.shape[1]
    K = fused_message.message_table_to_lanes(m_table)
    x = (h.double().index_select(0, src.long()) @ K.double()).view(E, -1, D)
    x = x.gather(1, bond.long().view(E, 1, 1).expand(E, 1, D)).squeeze(1) * mask[:, None]
    agg64 = torch.zeros(N, D, dtype=torch.float64, device=h.device).index_add_(0, dst.long(), x)
    step64 = gated_update(h.double(), agg64, {k: v.double() for k, v in gru.items()})
    cases = {
        "fused_message_aggregate": (
            agg64, fused_message.fused_message_aggregate(h, K, bond, src, dst, mask, N),
            fused_message.fused_message_aggregate_plain(h, K, bond, src, dst, mask, N)),
        "fused_mp_step": (
            step64, fused_step.fused_mp_step(h, m_table, gru, bond, src, dst, mask, N),
            fused_step.fused_mp_step_plain(h, m_table, gru, bond, src, dst, mask, N)),
    }
    parts = []
    for name, (ref, kernel, plain) in cases.items():
        stats = []
        for got in (kernel, plain):
            err = (got.double() - ref).abs()
            stats.append(f"max {err.max().item():.3e} rms {err.pow(2).mean().sqrt().item():.3e}")
        parts.append(f"{name} kernel {stats[0]}, plain {stats[1]}")
    log(f"[kernels] {tag} against f64: " + "; ".join(parts))


def gru_params(gen, D, dev):
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES

    return {k: (torch.randn(s, generator=gen) * 0.2).to(dev)
            for k, s in GATED_UPDATE_PARAM_SHAPES(D).items()}


def check_kernels(tag, h, m_table, gru, bond, src, dst, mask, N, tol, phase="kernels"):
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    msg = edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    msg = msg.to(h.dtype)
    K = fused_message.message_table_to_lanes(m_table)
    errs = {}
    errs["sorted_segment_sum"] = close(
        f"sorted_segment_sum {tag}",
        segment_sum.sorted_segment_sum(msg, dst, N),
        segment_sum.sorted_segment_sum_plain(msg, dst, N), tol, tol)
    errs["fused_message_aggregate"] = close(
        f"fused_message_aggregate {tag}",
        fused_message.fused_message_aggregate(h, K, bond, src, dst, mask, N),
        fused_message.fused_message_aggregate_plain(h, K, bond, src, dst, mask, N),
        tol, tol)
    errs["fused_mp_step"] = close(
        f"fused_mp_step {tag}",
        fused_step.fused_mp_step(h, m_table, gru, bond, src, dst, mask, N),
        fused_step.fused_mp_step_plain(h, m_table, gru, bond, src, dst, mask, N),
        tol, tol)
    torch.cuda.synchronize()
    log(f"[{phase}] {tag}: " + ", ".join(f"{k} max|err| {v:.3e}" for k, v in errs.items()))
    return errs


def phase_kernels(batch, V, dev):
    gen = torch.Generator().manual_seed(1)
    worst = {}
    # the batch-2048 shapes at the model's D = 32, and the anion at D = 64
    for side, D in (("cation", 32), ("anion", 32), ("anion", 64)):
        g = batch.cation if side == "cation" else batch.anion
        N = g.node_capacity
        m_table = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
        gru = gru_params(gen, D, dev)
        h32 = torch.randn(N, D, generator=gen).to(dev)
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            errs = check_kernels(
                f"{side} N={N} E={g.edge_capacity} D={D} h {str(dt)[6:]}", h32.to(dt),
                m_table, gru, g.bond_ids, g.src, g.dst, g.edge_mask, N, tol)
            if dt == torch.float32 and D == 32:
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
    rng = np.random.default_rng(2)
    h, m_table, bond, src, dst, mask, N = hard_case(dev, rng, V=V)
    gru = gru_params(gen, 32, dev)
    for dt in (torch.float32, torch.bfloat16):
        errs = check_kernels(f"hard case N={N} h {str(dt)[6:]}", h.to(dt), m_table, gru,
                             bond, src, dst, mask, N, F32_TOL)
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
    # the tensor-core kernel's type skipping: tiles that hold every type, up
    # to the most types D = 32 takes
    for types, per_node in ((V, V), (32, 8)):
        t_case = typed_case(dev, rng, types, per_node)
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            check_kernels(f"every type in every tile V={types} N={t_case[-1]} "
                          f"h {str(dt)[6:]}", t_case[0].to(dt), t_case[1], gru, *t_case[2:],
                          tol)
    g = batch.cation
    h32 = torch.randn(g.node_capacity, 32, generator=gen).to(dev)
    m32 = (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev)
    cation = (g.bond_ids, g.src, g.dst, g.edge_mask, g.node_capacity)
    check_repeatable("cation D=32 h float32", h32, m32, gru, *cation)
    accuracy_vs_f64("cation D=32 h float32", h32, m32, gru, *cation)
    check_refusals(h, m_table, gru, bond, src, dst, mask, N)
    return worst


def check_refusals(h, m_table, gru, bond, src, dst, mask, N):
    """What the kernels cannot take raises in the wrapper, before a launch."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum

    K = fused_message.message_table_to_lanes(m_table)
    zeros = lambda *shape: torch.zeros(*shape, device=h.device)
    # the library and the wrapper's FUSED_DIMS name the same widths
    lib = kernels._lib.library()
    taken = [d for d in range(1, 257) if lib.ionic_fused_max_types(d) > 0]
    if taken != list(fused_message.FUSED_DIMS):
        raise AssertionError(f"the library takes D in {taken}, the wrapper "
                             f"{list(fused_message.FUSED_DIMS)}")
    cases = {
        "D=20": lambda: fused_message.fused_message_aggregate(
            zeros(N, 20), zeros(20, 20 * 7), bond, src, dst, mask, N),
        "D=136": lambda: fused_step.fused_mp_step(
            zeros(N, 136), zeros(7, 136, 136), gru_params(torch.Generator(), 136, h.device),
            bond, src, dst, mask, N),
        "33 types at D=128": lambda: fused_message.fused_message_aggregate(
            zeros(N, 128), zeros(128, 128 * 33), bond, src, dst, mask, N),
        "33 types at D=32": lambda: fused_step.fused_mp_step(
            h, zeros(33, 32, 32), gru, bond, src, dst, mask, N),
        "dtype": lambda: fused_step.fused_mp_step(h.half(), m_table, gru, bond, src, dst,
                                                  mask, N),
        "strided": lambda: segment_sum.sorted_segment_sum(
            zeros(src.shape[0], 64)[:, ::2], dst, N),
        "device": lambda: fused_message.fused_message_aggregate(
            h, K.cpu(), bond, src, dst, mask, N),
    }
    kernels.reset_launch_counts()
    for what, call in cases.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] refused ({what}): {e}")
        else:
            raise AssertionError(f"the wrappers accepted an input they cannot take: {what}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"a refused call launched a kernel: {kernels.launch_counts()}")


# ---------------------------------------------------------------- phase 4

def symmetric_hard_case(dev, rng, V=7, D=32):
    """A reversal-closed graph (every edge's reverse, same bond and mask, is
    in the list): N = 1001, rows left empty (nodes 2-6 mod 7 that are not
    multiples of 3), node 500 a hub joined to multiples of 3 by 3100 pairs in
    both directions (a fifth of them masked), pairs with |src - dst| of 890
    and 999, masked pad self-loops with bond 0; dyadic values."""
    N = 1001
    pairs = [(n, n + 1, int(rng.integers(1, V)), True) for n in range(0, N - 1, 7)]
    for k in range(3100):
        s = 3 * int(rng.integers(0, 333))
        pairs.append((s if s != 500 else 0, 500, int(rng.integers(0, V)), k % 5 != 0))
    pairs += [(10, 900, 3, True), (999, 0, 2, True)]
    edges = [e for a, b, bond, m in pairs for e in ((a, b, bond, m), (b, a, bond, m))]
    edges += [(n, n, 0, False) for n in range(0, N, 97)]
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    fwd = sorted(zip(src[mask], dst[mask], bond[mask]))
    if fwd != sorted(zip(dst[mask], src[mask], bond[mask])):
        raise AssertionError("the hard case is not closed under reversal")
    h = rng.integers(-2, 3, size=(N, D)) / 4.0
    table = rng.integers(-4, 5, size=(V, D, D)) / 16.0
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(h, torch.float32), t(table, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def function_grads(fn, leaves, cot):
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def aggregate64(h, m_table, bond, src, dst, mask, N):
    """The fused aggregate evaluated in h's and m_table's dtype (f64 here):
    the plain version's ops without its f32 casts."""
    from ionic_mpnn_torch.ops.cuda import fused_message

    E, D = src.shape[0], h.shape[1]
    x = (h.index_select(0, src.long()) @ fused_message.message_table_to_lanes(m_table))
    x = x.view(E, -1, D).gather(1, bond.long().view(E, 1, 1).expand(E, 1, D)).squeeze(1)
    x = x * mask[:, None].to(x.dtype)
    return torch.zeros(N, D, dtype=h.dtype, device=h.device).index_add_(0, dst.long(), x)


def check_functions(tag, h, m_table, gru, bond, src, dst, mask, N, cot, phase="backward"):
    """The three autograd Functions' gradients against torch autograd of
    their plain forwards, on the card. The two fused Functions' dm_table
    (the table gradient's kernel) is held, at the same tolerance, to autograd
    of the same forward in f64 instead: each entry sums about E / V edge
    terms, and the f32 plain version's sgemm (depth E) is itself up to 1.5e-3
    off an f64 evaluation at the cation shape (PERF.md §6), past the
    1e-4 that the kernel holds; its distance is logged beside."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.gru import gated_update
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    lanes = fused_message.message_table_to_lanes
    keys = list(gru)
    msg = edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    cases = {
        "SortedSegmentSum (dmsg)": (
            lambda m: segment_sum.sorted_segment_sum(m, dst, N),
            lambda m: segment_sum.sorted_segment_sum_plain(m, dst, N), [msg]),
        "FusedMessageAggregate (dh, dm_table)": (
            lambda h_, m_: fused_message.fused_message_aggregate(
                h_, lanes(m_), bond, src, dst, mask, N),
            lambda h_, m_: fused_message.fused_message_aggregate_plain(
                h_, lanes(m_), bond, src, dst, mask, N), [h, m_table]),
        "FusedMPStep (dh, dm_table, dgru)": (
            lambda h_, m_, *g_: fused_step.fused_mp_step(
                h_, m_, dict(zip(keys, g_)), bond, src, dst, mask, N),
            lambda h_, m_, *g_: fused_step.fused_mp_step_plain(
                h_, m_, dict(zip(keys, g_)), bond, src, dst, mask, N),
            [h, m_table, *gru.values()]),
    }
    edges = (bond, src, dst, mask, N)
    f64 = {  # the forwards whose dm_table (grad 1) is held to f64
        "FusedMessageAggregate (dh, dm_table)": lambda h_, m_: aggregate64(h_, m_, *edges),
        "FusedMPStep (dh, dm_table, dgru)": lambda h_, m_, *g_: gated_update(
            h_, aggregate64(h_, m_, *edges), dict(zip(keys, g_))),
    }
    errs = {}
    for name, (fn, plain, leaves) in cases.items():
        got = function_grads(fn, leaves, cot)
        want = function_grads(plain, leaves, cot)
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if name in f64 and i == 1:
                ref = function_grads(f64[name], [x.double() for x in leaves], cot.double())[1]
                err = close(f"{name} grad {i} {tag} (against f64)", a, ref, GRAD_TOL, GRAD_TOL)
                over = lambda x: ((x.double() - ref).abs() - GRAD_TOL * (1 + ref.abs())).max()
                log(f"[{phase}] {name} dm_table {tag} against f64: kernel max|err| {err:.3e}, "
                    f"excess over rtol/atol {GRAD_TOL} {over(a).item():.2e}; the f32 plain "
                    f"autograd's max|err| {(b.double() - ref).abs().max().item():.3e}, excess "
                    f"{over(b).item():.2e}")
            else:
                err = close(f"{name} grad {i} {tag}", a, b, GRAD_TOL, GRAD_TOL)
            worst = max(worst, err)
        errs[name] = worst
    torch.cuda.synchronize()
    log(f"[{phase}] {tag}: " + ", ".join(f"{k} max|err| {v:.3e}" for k, v in errs.items()))


def phase_backward(batch, V, dev):
    """The dh launch against its plain version, then the Functions against
    plain autograd."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    gen = torch.Generator().manual_seed(4)
    cases = []
    for side in ("cation", "anion"):
        g = getattr(batch, side)
        N = g.node_capacity
        cases.append((f"{side} N={N} E={g.edge_capacity}",
                      torch.randn(N, 32, generator=gen).to(dev),
                      (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev),
                      g.bond_ids, g.src, g.dst, g.edge_mask, N,
                      torch.randn(N, 32, generator=gen).to(dev)))
    rng = np.random.default_rng(5)
    h, m_table, bond, src, dst, mask, N = symmetric_hard_case(dev, rng, V=V)
    cot = torch.tensor(rng.integers(-2, 3, size=(N, 32)) / 4.0, dtype=torch.float32,
                       device=dev)
    cases.append((f"reversal-closed hard case N={N} E={src.shape[0]}",
                  h, m_table, bond, src, dst, mask, N, cot))
    worst = 0.0
    for tag, h, m_table, bond, src, dst, mask, N, cot in cases:
        K = fused_message.message_table_to_lanes(m_table)
        dh, _ = fused_message.message_backward(cot, h, K, bond, src, dst, mask, N,
                                               csr_rowptr(dst, N), need_dK=False)
        want = fused_message.fused_message_aggregate_plain(
            cot, fused_message.transpose_lane_table(K), bond, src, dst, mask, N)
        err = close(f"dh launch {tag}", dh, want, F32_TOL, F32_TOL)
        log(f"[backward] dh launch {tag}: max|err| {err:.3e}")
        if not tag.startswith("anion"):
            worst = max(worst, err)
        check_functions(tag, h, m_table, gru_params(gen, 32, dev), bond, src, dst, mask,
                        N, cot)
    return worst


# ---------------------------------------------------------------- [widths]

WIDTHS = (8, 16, 48, 64, 128)  # the general kernel's widths held here; D = 32 in [kernels]
WIDTH_GRAD_DIMS = (64, 128)
TIMED_WIDTHS = (8, 16, 32, 48, 64, 128)  # D = 32: the specialisation, timed the same way
SCALING_DIMS = (64, 128)  # JAX's D-scaling arm (scripts/tpu_dim_scaling.py) past the model's 32
SCALING_ITERS, SCALING_WARMUP = 10, 3
WIDTH_CLI_DIM = 64
WIDTH_CLI_DATA = ("--n-viscosity", "100", "--n-mp", "400")  # the reference's 400 mp draws
WIDTH_CLI_EPOCHS = 2
GRAPH_CALLS = 20
FUSED_REPLACES = {
    "fused_message_aggregate": "ionic_mpnn_tpu/ops/pallas/fused_message.py:290",
    "fused_message_aggregate_dh": "ionic_mpnn_tpu/ops/pallas/fused_message.py:324",
    "fused_mp_step": "ionic_mpnn_tpu/ops/pallas/fused_step.py:268",
}


def graph_ms(fn, n=GRAPH_CALLS, replays=5):
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph (``training.graphs.Replay``), each replay timed with CUDA events,
    the median over ``replays`` divided by ``n``. The graph keeps the host
    out of the reading (a wrapper's host work outlasts a small kernel); its
    own gaps between launches, about a microsecond each, stay in. No
    profiler: wall-clock readings of later phases stay clean. The launches
    of the first call and the replays are taken off the counters."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training.graphs import Replay

    before = kernels.launch_counts(designs=True)
    graph = Replay(lambda: [fn() for _ in range(n)], torch.device("cuda"), graphed=True)
    graph()  # eagerly, then the capture
    graph()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    kernels.set_launch_counts(before)
    return statistics.median(times)


# The general kernel's two designs: its CUDA kernel, ionic_fused_force_design's
# code. The library chooses the blocks where their grid fills the card twice
# at D >= 64, the teams elsewhere; [widths] forces each in turn.
DESIGNS = {"teams": ("fused_message_team_kernel", 1), "blocks": ("fused_message_gen_kernel", 2)}
# Each width's times (ms per call, as width_times reads them) in the final
# call of the release before the 64-row blocks, where the teams served every
# width but 32, on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6): printed
# beside this run's times in the log, never in a row. D = 32 is the
# specialisation.
EARLIER_MS = {
    8: (0.02400, 0.02584, 0.05208), 16: (0.02560, 0.02708, 0.05847),
    32: (0.02110, 0.02329, 0.06042), 48: (0.07272, 0.07358, 0.18364),
    64: (0.09411, 0.09617, 0.23655), 128: (0.24136, 0.24133, 0.77679),
}
EARLIER_SCALING_MS = {64: 12.0990, 128: 26.0543}  # the D-scaling arm's step, same call


def bucket_pairs(bond, dst, mask, V):
    """P: the (destination node, bond type) pairs that hold a real edge, the
    typed buckets whose rows the fused kernels and the table gradient
    multiply by a type's D x D matrix (at most E_real)."""
    m = mask.bool()
    return int(torch.unique(dst[m].long() * V + bond[m].long()).numel())


def fused_bounds(N, E, E_real, P, D, V):
    """Each fused kernel's bytes (inputs read once, out written once), its
    products' flops (2 D² for each of the P typed buckets; the step's gates
    12 N D²) and its f32 adds on the CUDA cores (the buckets' E_real D) at
    this shape, h f32, as [times] counts them."""
    edge_bytes = E * (4 + 4 + 4 + 1)  # bond, src, dst, mask
    msg = N * D * 4 + D * V * D * 4 + edge_bytes + N * D * 4
    return {"fused_message_aggregate": (msg, 2 * P * D * D, E_real * D),
            "fused_message_aggregate_dh": (msg, 2 * P * D * D, E_real * D),
            "fused_mp_step": (msg + 4 * (6 * D * D + 5 * D),
                              2 * P * D * D + 12 * N * D * D, E_real * D)}


@contextlib.contextmanager
def forced_design(design):
    """The general kernel's design forced (``None``: the library's choice)."""
    from ionic_mpnn_torch.ops.cuda import _lib

    lib = _lib.library()
    before = lib.ionic_fused_force_design(DESIGNS[design][1] if design else 0)
    try:
        yield
    finally:
        lib.ionic_fused_force_design(before)


def width_times(D, h, m_table, gru, cot, bond, src, dst, mask, N, errs):
    """Each fused kernel at width D against its plain version and its bound,
    by graph_ms (device ms per call); at every D but 32 in each general
    design, and at the widths whose paths run the blocks their prologue."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    V = m_table.shape[0]
    K = fused_message.message_table_to_lanes(m_table)
    Kt = fused_message.transpose_lane_table(K)
    rowptr = csr_rowptr(dst, N)
    args = (bond, src, dst, mask, N)
    calls = {
        "fused_message_aggregate": (
            lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
            lambda: fused_message.fused_message_aggregate_plain(h, K, *args)),
        # the call includes the transpose of the table, as in [times]
        "fused_message_aggregate_dh": (
            lambda: fused_message.message_backward(cot, h, K, *args, rowptr, need_dK=False),
            lambda: fused_message.fused_message_aggregate_plain(cot, Kt, *args)),
        "fused_mp_step": (
            lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
            lambda: fused_step.fused_mp_step_plain(h, m_table, gru, *args)),
    }
    P = bucket_pairs(bond, dst, mask, V)
    bounds = fused_bounds(N, src.shape[0], int(mask.sum()), P, D, V)
    shape = {"N": N, "E": src.shape[0], "E_real": int(mask.sum()), "P": P, "D": D, "V": V}
    rows = []
    with torch.inference_mode():
        for i, (name, (kernel, plain)) in enumerate(calls.items()):
            b_ms, b_by = bound_ms(*bounds[name], TC_F32[0])
            plain_ms = graph_ms(plain)
            for design in ((None,) if D == 32 else tuple(DESIGNS)):
                with forced_design(design):
                    ms = graph_ms(kernel)
                cuda = DESIGNS[design][0] if design else "fused_message_tc_kernel"
                rows.append({"name": f"{name} D={D}" + (f" {design}" if design else ""),
                             "kernel": name, "design": design, "cuda_kernel": cuda,
                             "route": "cuda", "source": "ionic_mpnn_torch/csrc/fused_message.cu",
                             "replaces": FUSED_REPLACES[name],
                             "max_abs_err": errs.get(f"{name} {design}"),
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": None,
                             "timing": f"CUDA graph of {GRAPH_CALLS} calls, events",
                             "shape": shape})
                earlier = EARLIER_MS[D][i] if D in EARLIER_MS else None
                log(f"[widths] time {rows[-1]['name']} ({cuda}): {ms:.5f} ms (graph of "
                    f"{GRAPH_CALLS} calls), plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
                    f"({b_by}), {ms / b_ms:.2f}x the bound"
                    + (f"; the earlier release {earlier:.5f} ms" if earlier else ""))
        if D in SCALING_DIMS:
            rows.append(prologue_row(D, K, gru, shape))
    return rows


TABLE_GRAD_SOURCE = "ionic_mpnn_torch/csrc/table_grad.cu"
TABLE_GRAD_REPLACES = ("ionic_mpnn_tpu/ops/pallas/fused_message.py:338-347 (_vjp_bwd's dK, "
                       "XLA ops)")
# its tolerance against the plain version: 1e-5 of the table's largest entry
# (an entry sums about E / V products whose partial sums reach the largest
# entries: two f32 orders differ by ulps of those, not of a small entry)
TABLE_GRAD_TOL = 1e-5


def table_grad_bounds(N, E, E_real, P, D, V):
    """The table gradient's bytes (g and h f32 read once, the edge arrays,
    dK written once), its products' flops (Y_vᵀ g over the P typed buckets:
    2 P D²) and its bucket adds (E_real D, f32 on the CUDA cores)."""
    return 2 * N * D * 4 + E * (4 + 4 + 4 + 1) + D * V * D * 4, 2 * P * D * D, E_real * D


# tg_plan's plan (walkers, slots, rows of a j-slice, slices, types a group,
# groups, n-tiles of a fragment group) at each width and type count that
# check_table_grad meets, with the H100's 232,448 bytes of shared memory a
# block: tests/test_torch_tensorcore_math.py holds its mirror of tg_plan,
# whose accumulation order it checks, to this table, and check_table_grad
# holds the library's plan to it
TABLE_GRAD_PLANS = {
    (8, 7): (8, 4, 16, 1, 7, 1, 1), (16, 7): (8, 4, 16, 1, 7, 1, 1),
    (32, 7): (8, 4, 32, 1, 7, 1, 2), (48, 7): (8, 3, 32, 2, 7, 1, 2),
    (64, 7): (8, 2, 32, 2, 7, 1, 4), (128, 7): (4, 3, 32, 4, 7, 1, 4),
    (8, 32): (8, 4, 16, 1, 32, 1, 1), (16, 32): (8, 4, 16, 1, 32, 1, 1),
    (32, 32): (4, 4, 32, 1, 32, 1, 2), (48, 32): (8, 2, 32, 2, 16, 2, 2),
    (64, 32): (8, 2, 32, 2, 11, 3, 4), (128, 32): (4, 2, 32, 4, 8, 4, 4),
}
TABLE_GRAD_PLAN_KEYS = ("walkers", "slots", "js", "slices", "types_a_group", "groups", "ng")


def check_table_grad(tag, cot, h, bond, src, dst, mask, N, V, phase="widths"):
    """The table-gradient kernel against its plain version (within
    TABLE_GRAD_TOL of the table's largest entry), two launches bit-equal;
    returns max |err|."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    rowptr = csr_rowptr(dst, N)
    got = fused_message.fused_message_table_grad(cot, h, bond, src, dst, mask, V, rowptr)
    again = fused_message.fused_message_table_grad(cot, h, bond, src, dst, mask, V, rowptr)
    want = fused_message.fused_message_table_grad_plain(cot, h, bond, src, dst, mask, V)
    scale = want.abs().max().item()
    err = close(f"fused_message_table_grad {tag}", got, want, 0.0, TABLE_GRAD_TOL * scale)
    if not torch.equal(got, again):
        raise AssertionError(f"fused_message_table_grad {tag}: two launches differ by "
                             f"{(got - again).abs().max().item():.3e}")
    plan = fused_message.table_grad_plan(h.shape[1], V, N)
    want_plan = TABLE_GRAD_PLANS.get((h.shape[1], V))
    if want_plan is None or tuple(plan[k] for k in TABLE_GRAD_PLAN_KEYS) != want_plan:
        raise AssertionError(f"fused_message_table_grad {tag}: the library's plan {plan}, the "
                             f"tests' mirror's {want_plan}")
    log(f"[{phase}] dK {tag}: max|err| {err:.3e} ({err / max(scale, 1e-30):.2e} of the largest "
        f"entry {scale:.3e}), two launches bit-equal; plan {plan}")
    return err


def table_grad_rows(D, cases, gen):
    """The table gradient at width D on each (tag, h, bond, src, dst, mask,
    N, V) case: held to its plain version with h f32 and bf16 and timed
    against it (graph_ms, h f32). The cation row carries the kernel's name
    (its launches come from the paths); the others are shapes only."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    rows = []
    for tag, h, bond, src, dst, mask, N, V in cases:
        cot = torch.randn(N, D, generator=gen).to(h.device)
        err = max(check_table_grad(f"D={D} {tag} h {str(dt)[6:]}", cot, h.to(dt), bond, src,
                                   dst, mask, N, V) for dt in (torch.float32, torch.bfloat16))
        rowptr = csr_rowptr(dst, N)
        E_real = int(mask.sum())
        P = bucket_pairs(bond, dst, mask, V)
        b_ms, b_by = bound_ms(*table_grad_bounds(N, src.shape[0], E_real, P, D, V), TC_F32[0])
        with torch.inference_mode():
            ms = graph_ms(lambda: fused_message.fused_message_table_grad(cot, h, bond, src, dst,
                                                                         mask, V, rowptr))
            plain_ms = graph_ms(lambda: fused_message.fused_message_table_grad_plain(
                cot, h, bond, src, dst, mask, V))
        side = tag.split()[0]
        rows.append({"name": f"fused_message_table_grad D={D} {side}",
                     "kernel": "fused_message_table_grad" if side == "cation" else None,
                     "design": None, "cuda_kernel": f"{TABLE_GRAD_KERNEL}, table_grad_sum_kernel",
                     "route": "cuda", "source": TABLE_GRAD_SOURCE,
                     "replaces": TABLE_GRAD_REPLACES, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None,
                     "timing": f"CUDA graph of {GRAPH_CALLS} calls, events",
                     "plan": fused_message.table_grad_plan(D, V, N),
                     "shape": {"N": N, "E": src.shape[0], "E_real": E_real, "P": P, "D": D,
                               "V": V}})
        log(f"[widths] time dK D={D} {tag} ({TABLE_GRAD_KERNEL} and its sum): {ms:.5f} ms "
            f"(graph of {GRAPH_CALLS} calls), torch ops {plain_ms:.5f} ms "
            f"({plain_ms / ms:.2f}x the kernel's), bound {b_ms:.5f} ms ({b_by}), "
            f"{ms / b_ms:.2f}x the bound")
    return rows


def prologue_row(D, K, gru, shape):
    """The blocks' prologue (fused_message_split_kernel) at width D, as a
    step launch runs it (the table and W): its planes against the plain
    split bit for bit, its time and its bound (the table and W read once,
    the planes written once)."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.fused_step import pack_gru_weights

    w = pack_gru_weights(gru)[0]
    got, want = fused_message.fused_split(K, w), fused_message.fused_split_plain(K, w)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if err != 0.0:
        raise AssertionError(f"[widths] fused_message_split D={D}: planes differ by {err:.3e}")
    scratch = torch.empty(fused_message.fused_split_bytes(K, w), dtype=torch.uint8,
                          device=K.device)
    nbytes = 4 * (K.numel() + w.numel()) + scratch.numel()
    b_ms, b_by = bound_ms(nbytes, 5 * K.numel() + 4 * w.numel())
    row = {"name": f"fused_message_split D={D}", "kernel": "fused_message_split",
           "design": "blocks", "cuda_kernel": "fused_message_split_kernel", "route": "cuda",
           "source": "ionic_mpnn_torch/csrc/fused_message.cu",
           "replaces": FUSED_REPLACES["fused_mp_step"] + " (the operands of its general-width "
                       "port, split once a call)",
           "max_abs_err": err,
           "ms": graph_ms(lambda: fused_message.fused_split(K, w, scratch, read=False)),
           "plain_ms": graph_ms(lambda: fused_message.fused_split_plain(K, w)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "timing": f"CUDA graph of {GRAPH_CALLS} calls, events; the step's prologue (the "
                     "table and W), the message's splits the table alone",
           "shape": shape}
    log(f"[widths] time {row['name']} (the blocks' prologue, the step's: table and W): "
        f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"{row['ms'] / b_ms:.2f}x the bound; planes equal to the plain split bit for bit")
    return row


def anion_times(D, h, m_table, gru, bond, src, dst, mask, N):
    """The message and step kernels on the bench batch's anion graph (159
    blocks of 64 rows) in each general design, by graph_ms: the shape on
    which the library takes the teams."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    K = fused_message.message_table_to_lanes(m_table)
    rowptr = csr_rowptr(dst, N)
    args = (bond, src, dst, mask, N)
    calls = {"fused_message_aggregate": lambda: fused_message.fused_message_aggregate(
                 h, K, *args, rowptr=rowptr),
             "fused_mp_step": lambda: fused_step.fused_mp_step(h, m_table, gru, *args,
                                                              rowptr=rowptr)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for design in DESIGNS:
                with forced_design(design):
                    out[f"{name} {design}"] = graph_ms(fn)
    log(f"[widths] anion N={N} D={D}, ms per call (graph of {GRAPH_CALLS} calls): "
        + ", ".join(f"{k} {v:.5f}" for k, v in out.items()))
    return out


def block_counts():
    """The fused launches since the last reset that ran the 64-row blocks."""
    from ionic_mpnn_torch.ops import cuda as kernels

    return {k: v for k, v in kernels.launch_counts(designs=True).items()
            if k.endswith("_blocks")}


def scaling_arm(D, records, vocab, batch, dev):
    """JAX's D-scaling arm at atom_dim D on the card's default
    configuration (``message_impl`` and ``compute_dtype`` "auto"): one train
    step against plain ``gather`` f32 reading the same bf16-rounded tensors
    from the same seed-0 weights ([train]'s check and tolerances, launches
    exact), then ``bench_packed_train_step`` at batch 2048 as the arm runs
    it (JAX harness :105, :118-123), launches exact over its calls."""
    from ionic_mpnn_torch.benchmarks import bench_packed_train_step
    from ionic_mpnn_torch.config import (TrainConfig, resolve_compute_dtype,
                                         resolve_message_impl, viscosity_config)
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.ops.cuda import _lib

    V = vocab.bond_vocab_size + 1
    impl, dtype = resolve_message_impl("auto", dev), resolve_compute_dtype("auto", dev)
    if (impl, dtype) != ("pallas_step", "bfloat16"):
        raise AssertionError(f"[widths] auto resolved to {impl} {dtype} on the card")
    # the arm's widths (JAX harness :118-123): fp_size = D, mixing max(20, D // 2)
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=4,
                            atom_dim=D, fp_size=D, mixing_size=max(20, D // 2))
    kcfg = base.replace(message_impl=impl, compute_dtype=dtype)
    pcfg = base.replace(message_impl="gather", scatter_impl="xla", compute_dtype="float32")
    model = ViscosityModel(kcfg, seed=0)
    plain = ViscosityModel(pcfg, seed=0)
    plain.load_state_dict(model.state_dict())
    round_in_every_forward(plain)
    tcfg = TrainConfig()
    ref_name = f"D={D} gather f32, bf16-rounded (plain)"
    ref = train_arm(ref_name, plain, pcfg, tcfg, [batch])
    arm = train_arm(f"D={D} {impl} {dtype}", model, kcfg, tcfg, [batch])
    held = hold_train_arm(f"D={D} {impl} {dtype}", arm, ref, ref_name, dtype)
    launches = dict(arm["counts"])
    per_step = kernel_launches(impl, "xla")[0]
    # the checked step's launches that ran the blocks: every launch on each
    # graph whose node count takes them (half of each count a graph)
    lib = _lib.library()
    nodes = [g.node_capacity for g in (batch.cation, batch.anion)]
    takes = {k: [n for n in nodes if lib.ionic_fused_scratch_bytes(
                 D, V, int(k == "fused_mp_step"), n) > 0] for k in FUSED_REPLACES}
    blocks = block_counts()
    want = {f"{k}_blocks": per_step.get(k, 0) // 2 * len(takes[k]) for k in FUSED_REPLACES}
    if blocks != want:
        raise AssertionError(f"[widths] D-scaling arm D={D}: blocks launches {blocks}, "
                             f"expected {want} (the graphs that take the blocks: {takes})")
    kernels.reset_launch_counts()
    r = bench_packed_train_step(records, vocab, batch_size=BATCH, num_steps=4,
                                iters=SCALING_ITERS, warmup=SCALING_WARMUP,
                                compute_dtype=dtype, message_impl=impl, atom_dim=D)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: (SCALING_ITERS + SCALING_WARMUP) * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"[widths] D-scaling arm D={D}: launches {counts}, expected {want}")
    # the bench packs its own batch: each graph takes the blocks in all of its
    # launches or in none
    n = SCALING_ITERS + SCALING_WARMUP
    for k, v in block_counts().items():
        whole = n * per_step.get(k[:-len("_blocks")], 0) // 2
        if whole == 0 or v % whole:
            raise AssertionError(f"[widths] D-scaling arm D={D}: {k} {v} is not a whole "
                                 f"graph's {whole}")
        blocks[k] += v
    launches.update(blocks)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    out = {"atom_dim": D, "config": f"{impl} {dtype}", "losses": arm["losses"],
           "ref_losses": ref["losses"], "step_ms": 1e3 / r.steps_per_s,
           "edges_per_s": r.edges_per_s, "message_edges_per_step": r.message_edges_per_step,
           "device": r.device, "launches": launches}
    log(f"[widths] D-scaling arm atom_dim {D} ({impl} {dtype}, batch {BATCH}): one train step "
        f"losses {arm['losses']}{held}; bench_packed_train_step {out['step_ms']:.4f} ms per "
        f"step (the earlier release {EARLIER_SCALING_MS.get(D)} ms), {r.edges_per_s:.6e} "
        f"message-edges/s ({r.message_edges_per_step} per step), launches {counts}; of all "
        f"the arm's launches, the blocks ran {blocks}")
    return out


def width_cli(D):
    """``train_melting_point --atom-dim D`` for 2 epochs as [chain] runs the
    CLIs (a process of its own, JAX unimportable), on ``prepare_data
    --synthetic`` at 100 viscosity rows and the reference's 400 melting-point
    draws. Its launches are exact: 16 ``fused_message_aggregate`` (8 ``dh``)
    a train step, 8 ``fused_mp_step`` a train step and a forward (each
    epoch's dev eval and ``evaluate_splits``' batches)."""
    import tempfile

    from ionic_mpnn_torch.config import resolve_onehot_window
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.data.reference_io import load_pickle
    from ionic_mpnn_torch.training import random_split

    with tempfile.TemporaryDirectory() as tmp:
        data, res = Path(tmp) / "data", Path(tmp) / "melting_point"
        out = {}
        for name, args in (
                ("prepare_data", ["--data-dir", str(data), "--synthetic", *WIDTH_CLI_DATA]),
                ("train_melting_point", ["--data", str(data / "mp_id_data.pkl"), "--vocab",
                                         str(data / "vocab.pkl"), "--out-dir", str(res),
                                         "--epochs", str(WIDTH_CLI_EPOCHS),
                                         "--atom-dim", str(D)])):
            cmd = [sys.executable, "-c", CHAIN_NO_JAX, f"ionic_mpnn_torch.cli.{name}", *args]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                                  timeout=CHAIN_TIMEOUT)
            out[f"{name}_s"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"[widths] {name} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        m = re.search(r"^kernel launches (\{.*\})$", proc.stdout, re.M)
        if m is None:
            raise AssertionError("[widths] train_melting_point printed no launch counts")
        counts = json.loads(m.group(1))
        metrics = chain_metrics(proc.stdout)
        if set(metrics) != {"Train", "Dev", "Test"} or not all(
                np.isfinite(v).all() for v in metrics.values()):
            raise AssertionError(f"[widths] train_melting_point printed {metrics}")
        # the forwards the CLI runs on batches it packs without shuffling
        records = load_pickle(data / "mp_id_data.pkl")
        split = [[records[i] for i in idx] for idx in random_split(len(records))]
        plan = plan_capacities(records, batch_size=32, with_temperature=False, target_key="mp",
                               edge_layout="sorted",
                               window=resolve_onehot_window("bfloat16", 0, atom_dim=D))
        train_b, dev_b, test_b = (sum(1 for _ in iter_batches(x, plan)) for x in split)
    from ionic_mpnn_torch.ops.cuda import _lib

    if any(_lib.library().ionic_fused_scratch_bytes(D, 1, gru, plan.node_cap) for gru in (0, 1)):
        raise AssertionError(f"[widths] the CLI's batches of {plan.node_cap} nodes take the "
                             "blocks: its launches would count as the teams'")
    steps, rem = divmod(counts["fused_message_aggregate_dh"], 8)
    forwards = WIDTH_CLI_EPOCHS * dev_b + train_b + dev_b + test_b
    want = {"sorted_segment_sum": 0, "fused_message_aggregate": 16 * steps,
            "fused_message_aggregate_dh": 8 * steps, "fused_message_table_grad": 8 * steps,
            "fused_mp_step": 8 * (steps + forwards)}
    if rem or steps < WIDTH_CLI_EPOCHS or counts != want:
        raise AssertionError(f"[widths] train_melting_point --atom-dim {D}: launches {counts}, "
                             f"expected {want} ({steps} train steps, {forwards} forwards)")
    out.update(launches=counts, train_steps=steps, forwards=forwards, metrics=metrics)
    log(f"[widths] train_melting_point --atom-dim {D} --epochs {WIDTH_CLI_EPOCHS}: exit 0 in "
        f"{out['train_melting_point_s']:.2f} s ({steps} train steps, {forwards} forwards), "
        f"launches {counts}; " + ", ".join(f"{k} R2 {v[0]:.4f}" for k, v in metrics.items()))
    return out


def phase_widths(batch, records, vocab, dev):
    """The fused kernels at the general kernel's widths, then the paths that
    run them: JAX's D-scaling arm and the melting-point CLI at
    ``--atom-dim 64``. Returns the phase's summary, the launches of those
    paths per width, and each width's timed rows."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    t_phase = time.perf_counter()
    V = vocab.bond_vocab_size + 1
    gen = torch.Generator().manual_seed(6)
    rng = np.random.default_rng(7)
    out = {"errs": {}, "scaling": [], "cli": None}
    rows = []
    for D in TIMED_WIDTHS:
        g = batch.cation
        N = g.node_capacity
        cation = (g.bond_ids, g.src, g.dst, g.edge_mask, N)
        h = torch.randn(N, D, generator=gen).to(dev)
        m_table = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
        gru = gru_params(gen, D, dev)
        cot = torch.randn(N, D, generator=gen).to(dev)
        worst = {}
        if D in WIDTHS:
            cases = [(f"cation N={N} E={g.edge_capacity} V={V}", h, m_table, *cation)]
            a = batch.anion
            cases.append((f"anion N={a.node_capacity} E={a.edge_capacity} V={V}",
                          torch.randn(a.node_capacity, D, generator=gen).to(dev),
                          (torch.randn(V, D, D, generator=gen) * 0.2).to(dev),
                          a.bond_ids, a.src, a.dst, a.edge_mask, a.node_capacity))
            t_case = typed_case(dev, rng, 32, 8, D=D)
            cases.append((f"every type in every tile V=32 N={t_case[-1]}", *t_case))
            # each case in each general design (the library's choice serves
            # the bench's cation graph with the blocks at D >= 64, its anion
            # graph and D < 64 with the teams)
            for design in DESIGNS:
                with forced_design(design):
                    for tag, h_, m_, bond, src, dst, mask, n in cases:
                        tag = f"{tag} {design}"
                        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
                            errs = check_kernels(f"D={D} {tag} h {str(dt)[6:]}", h_.to(dt), m_,
                                                 gru, bond, src, dst, mask, n, tol,
                                                 phase="widths")
                            if dt == torch.float32:
                                for k, v in errs.items():
                                    worst[f"{k} {design}"] = max(
                                        worst.get(f"{k} {design}", 0.0), v)
                        K = fused_message.message_table_to_lanes(m_)
                        g_ = torch.randn(n, D, generator=gen).to(dev)
                        dh, _ = fused_message.message_backward(g_, h_, K, bond, src, dst, mask,
                                                               n, csr_rowptr(dst, n),
                                                               need_dK=False)
                        want = fused_message.fused_message_aggregate_plain(
                            g_, fused_message.transpose_lane_table(K), bond, src, dst, mask, n)
                        err = close(f"dh launch D={D} {tag}", dh, want, F32_TOL, F32_TOL)
                        key = f"fused_message_aggregate_dh {design}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        log(f"[widths] dh launch D={D} {tag}: max|err| {err:.3e}")
                    if D in WIDTH_GRAD_DIMS:
                        # weights scaled by fan-in (0.2 at D = 32, as in [backward]):
                        # at 0.2 the gates saturate as D grows, and at D = 128 plain
                        # f32 autograd itself reads 2x the bound against an f64
                        # evaluation (the kernel path 1.1x; PERF.md §6)
                        fan_in = math.sqrt(32 / D)
                        check_functions(f"D={D} cation N={N} {design} (weights x "
                                        f"{fan_in:.3f})", h, m_table * fan_in,
                                        {k: v * fan_in for k, v in gru.items()},
                                        *cation, cot, phase="widths")
                    if D == max(WIDTHS):
                        check_repeatable(f"D={D} cation h float32 {design}", h, m_table, gru,
                                         *cation, phase="widths")
            out["errs"][D] = worst
        rows += width_times(D, h, m_table, gru, cot, *cation, worst)
        # the backward's table gradient at this width: the cation, anion and
        # every-type (V = 32) graphs, against its plain version (PyTorch ops)
        a = batch.anion
        t_case = typed_case(dev, rng, 32, 8, D=D)
        rows += table_grad_rows(D, [
            (f"cation N={N} E={g.edge_capacity} V={V}", h, *cation[:4], N, V),
            (f"anion N={a.node_capacity} E={a.edge_capacity} V={V}",
             torch.randn(a.node_capacity, D, generator=gen).to(dev), a.bond_ids, a.src, a.dst,
             a.edge_mask, a.node_capacity, V),
            (f"V=32 every type in every tile N={t_case[-1]}", t_case[0], *t_case[2:6],
             t_case[6], 32)], gen)
        if D in SCALING_DIMS:
            a = batch.anion
            out.setdefault("anion_ms", {})[D] = anion_times(
                D, torch.randn(a.node_capacity, D, generator=gen).to(dev), m_table, gru,
                a.bond_ids, a.src, a.dst, a.edge_mask, a.node_capacity)
    launches = {D: {} for D in SCALING_DIMS}
    for D in SCALING_DIMS:
        arm = scaling_arm(D, records, vocab, batch, dev)
        out["scaling"].append(arm)
        launches[D] = arm["launches"]
    out["cli"] = width_cli(WIDTH_CLI_DIM)
    for k, v in out["cli"]["launches"].items():
        launches[WIDTH_CLI_DIM][k] = launches[WIDTH_CLI_DIM].get(k, 0) + v
    for r in rows:
        at = launches.get(r["shape"]["D"], {})
        if r["kernel"] == "fused_message_split":  # one a launch of the blocks
            r["launches"] = (at.get("fused_message_aggregate_blocks", 0)
                             + at.get("fused_mp_step_blocks", 0))
        elif r.get("design") is None:
            r["launches"] = at.get(r["kernel"], 0)
        else:
            blocks = at.get(f"{r['kernel']}_blocks", 0)
            r["launches"] = blocks if r["design"] == "blocks" else at.get(r["kernel"], 0) - blocks
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[widths] launches per width {launches}; phase {out['seconds']:.1f} s")
    return out, rows


# ---------------------------------------------------------------- phase 5

CONFIGS = [  # (name, message_impl, scatter_impl, compute_dtype, kernel it runs,
    #           plain reference, tolerance)
    ("pallas_step f32", "pallas_step", "xla", "float32", "fused_mp_step",
     "float32", MODEL_TOL),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "fused_mp_step",
     "float32, bf16-rounded", MODEL_TOL),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "fused_message_aggregate",
     "float32", MODEL_TOL),
    ("pallas_fused bf16", "pallas_fused", "xla", "bfloat16", "fused_message_aggregate",
     "bfloat16", BF16_MODEL_TOL),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "sorted_segment_sum",
     "float32", MODEL_TOL),
]


# bf16 configurations round these parameters to bf16 before any arithmetic
# (the embedding lookup and the bond-type table); the rest of pallas_step's
# math is f32, so f32 gather reading the same three tensors rounded is its
# exact plain counterpart (round_in_every_forward).
BF16_ROUNDED = ("atom_embed", "bond_embed", "bond_transform")


def phase_main_path(records, plan, vocab, dev):
    from ionic_mpnn_torch.config import viscosity_config
    from ionic_mpnn_torch.data import iter_batches
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import predict

    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    plain = ViscosityModel(base, seed=0)  # the port's seeded Keras-style init
    state = plain.state_dict()
    n_fwd = sum(1 for _ in iter_batches(records, plan))
    if n_fwd != N_BATCHES:
        raise AssertionError(f"expected {N_BATCHES} batches, the plan gives {n_fwd}")
    batch0 = next(iter_batches(records, plan)).to(dev)

    def reference(kind):
        """Plain gather on the card (f32; f32 with the bf16-rounded tensors;
        bf16): predictions and batch-0 outputs."""
        model = plain
        if kind == "float32, bf16-rounded":
            model = ViscosityModel(base, seed=0)
            model.load_state_dict(state)
            round_in_every_forward(model)
        elif kind == "bfloat16":
            model = ViscosityModel(base.replace(compute_dtype="bfloat16"), seed=0)
            model.load_state_dict(state)
        kernels.reset_launch_counts()
        pred = predict(model, records, plan)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"plain path launched kernels: {kernels.launch_counts()}")
        if pred.shape != (len(records),) or not np.isfinite(pred).all():
            raise AssertionError("plain predictions are not finite of the right shape")
        with torch.inference_mode():
            return pred, model(batch0)

    refs = {kind: reference(kind) for kind in ("float32", "float32, bf16-rounded",
                                                "bfloat16")}
    models = {"gather f32 (plain)": plain}
    launches = {}
    for name, impl, scatter, dtype, kernel, ref, tol in CONFIGS:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        models[name] = model
        kernels.reset_launch_counts()
        pred = predict(model, records, plan)
        counts = kernels.launch_counts()
        want = {k: (8 * n_fwd if k == kernel else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        ref_pred, ref_out = refs[ref]
        err = close(f"predict {name}", torch.from_numpy(pred), torch.from_numpy(ref_pred),
                    *tol)
        with torch.inference_mode():
            out = model(batch0)
        for key in ("pred", "mixed", "fp_cat", "fp_an"):
            close(f"{name} {key}", out[key], ref_out[key], *tol)
        log(f"[main] {name}: predict over {len(records)} records in {n_fwd} batches, "
            f"{kernel} launched {counts[kernel]} times, pred max|err| {err:.3e} "
            f"vs plain gather {ref} (rtol/atol {tol[0]})")
    return models, batch0, launches, state


class RoundToBf16(torch.nn.Module):
    def forward(self, x):
        return x.to(torch.bfloat16).float()


def round_in_every_forward(model):
    """Make an f32 model read the tensors that a bf16 ``pallas_step`` model
    rounds to bf16 rounded, in every forward (so after each update too), and
    round their gradients as that model's casts do."""
    from torch.nn.utils import parametrize

    for module in list(model.modules()):
        for name in BF16_ROUNDED:
            if name in module._parameters:
                parametrize.register_parametrization(module, name, RoundToBf16())


def use_onehot_roundings(model):
    """Make a plain ``gather`` bf16 model round where a bf16 onehot model
    rounds: the bond-type table and every message to bf16 (then summed in
    f32), so that it is the one-hot formulation's plain counterpart."""
    from ionic_mpnn_torch.models.layers import BondMatrixMessage
    from ionic_mpnn_torch.ops.message import bond_type_matrices, edge_messages_from_table

    class RoundedGatherMessage(BondMatrixMessage):
        def forward(self, node_states, bond_table, bond_ids, src, dst, edge_mask, **_):
            dt = self.compute_dtype
            m_table = bond_type_matrices(bond_table.to(dt), self.bond_transform.to(dt))
            msg = edge_messages_from_table(node_states.to(dt), bond_ids, src,
                                           m_table.to(dt).float())
            msg = msg.to(dt).float() * edge_mask[:, None]
            return torch.zeros(node_states.shape[0], msg.shape[1], device=msg.device
                               ).index_add_(0, dst.long(), msg)

    for module in model.modules():
        if isinstance(module, BondMatrixMessage) and module.impl == "gather":
            module.__class__ = RoundedGatherMessage


def param_name(name):
    return name.replace("parametrizations.", "").replace(".original", "")


# ---------------------------------------------------------------- phase 6

def kernel_launches(impl, scatter):
    """Kernel launches of the 4-step model per train step and per forward:
    per train step 8 fused_mp_step + 16 fused_message_aggregate (8 remat,
    8 dh) + 8 fused_message_table_grad (dK) for pallas_step, 16
    fused_message_aggregate (8 forward, 8 dh) + 8 dK for pallas_fused, 8
    sorted_segment_sum for the pallas scatter; per forward 8 of the
    configuration's kernel."""
    if impl == "pallas_step":
        return ({"fused_mp_step": 8, "fused_message_aggregate": 16,
                 "fused_message_aggregate_dh": 8, "fused_message_table_grad": 8},
                {"fused_mp_step": 8})
    if impl == "pallas_fused":
        return ({"fused_message_aggregate": 16, "fused_message_aggregate_dh": 8,
                 "fused_message_table_grad": 8}, {"fused_message_aggregate": 8})
    if scatter == "pallas":
        return {"sorted_segment_sum": 8}, {"sorted_segment_sum": 8}
    return {}, {}


TRAIN_ARMS = [  # (name, message_impl, scatter_impl, compute_dtype, weights,
    #              plain reference arm)
    ("gather f32 (plain)", "gather", "xla", "float32", "as is", None),
    ("gather f32, bf16-rounded (plain)", "gather", "xla", "float32", "rounded in forward",
     None),
    ("gather bf16 (plain)", "gather", "xla", "bfloat16", "as is", None),
    ("pallas_step f32", "pallas_step", "xla", "float32", "as is", "gather f32 (plain)"),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "as is",
     "gather f32, bf16-rounded (plain)"),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "as is", "gather f32 (plain)"),
    ("pallas_fused bf16", "pallas_fused", "xla", "bfloat16", "as is", "gather bf16 (plain)"),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "as is",
     "gather f32 (plain)"),
]
TIMED_ARMS = ("gather f32 (plain)", "pallas_step f32", "pallas_step bf16",
              "pallas_fused f32", "pallas_fused bf16", "gather+pallas scatter f32")


def grads_close(name, got, want, tol):
    worst = 0.0
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        scale = w.abs().max().item()
        err = (g - w).abs()
        excess = err - tol * (w.abs() + scale)
        if excess.max().item() > 0:
            raise AssertionError(f"{name} gradient of {k}: max |err| {err.max().item():.3e} "
                                 f"beyond {tol} of |want| + max|want| ({scale:.3e})")
        worst = max(worst, err.max().item() / max(scale, 1e-30))
    return worst


def train_arm(tag, model, cfg, tcfg, batches):
    """The first step's gradients (before any update), then one train step
    per batch with the launch counters zeroed just before and read just
    after; they must read the configuration's per-step launches exactly."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import data_loss, l2_penalty, make_train_step

    per_step = kernel_launches(cfg.message_impl, cfg.scatter_impl)[0]
    b0 = batches[0]
    loss = (data_loss(model(b0)["pred"], b0.y, b0.sample_mask, tcfg.loss, tcfg.huber_delta)
            + l2_penalty(model, cfg.fp_l2))
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train {tag}: gradient of {k} is "
                                 f"{'missing' if p.grad is None else 'not finite'}")
        grads[param_name(k)] = p.grad.detach().clone()
    # the graph of that backward holds the parameters' gradient accumulators
    # on this stream; a capture must not meet them (training/graphs.py)
    del loss
    step = make_train_step(model, cfg, tcfg)  # its optimizer from tcfg
    kernels.reset_launch_counts()
    losses = [step(b)["loss"] for b in batches]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    losses = [float(x) for x in losses]
    want = {k: len(batches) * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"train {tag}: launch counts {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {tag}: losses {losses}")
    return {"step": step, "grads": grads, "losses": losses, "counts": counts}


def hold_train_arm(tag, arm, ref, ref_name, dtype):
    """An arm's first gradients and its losses against its plain arm's
    (TRAIN_TOL); returns the log line's comparison."""
    grad_tol, loss_tols = TRAIN_TOL[dtype]
    g_err = grads_close(f"train {tag}", arm["grads"], ref["grads"], grad_tol)
    for i, (a, b, rt) in enumerate(zip(arm["losses"], ref["losses"], loss_tols)):
        if abs(a - b) > rt * abs(b):
            raise AssertionError(f"train {tag}: loss of step {i + 1} {a!r} vs "
                                 f"{b!r} of {ref_name}, beyond rtol {rt}")
    return (f"; vs {ref_name}: max gradient |err| {g_err:.3e} of the tensor's max, loss "
            f"rtol {[abs(a / b - 1) for a, b in zip(arm['losses'], ref['losses'])]}")


def phase_train(records, plan, vocab, dev, state):
    """3 train steps per arm from the same weights on the same 3 batches."""
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches
    from ionic_mpnn_torch.models import ViscosityModel

    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    tcfg = TrainConfig()
    host_batches = list(iter_batches(records, plan))
    batches = [b.to(dev) for b in host_batches]
    arms, train_launches = {}, {}
    for name, impl, scatter, dtype, weights, ref in TRAIN_ARMS:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        if weights == "rounded in forward":
            round_in_every_forward(model)
        arms[name] = arm = train_arm(name, model, cfg, tcfg, batches)
        for k, v in arm["counts"].items():
            train_launches[k] = train_launches.get(k, 0) + v
        msg = f"[train] {name}: losses {arm['losses']}, launches {arm['counts']}"
        if ref is not None:
            msg += hold_train_arm(name, arm, arms[ref], ref, dtype)
        log(msg)
    for name in TIMED_ARMS:
        arms[name]["grads"] = None  # free them; the step objects are timed later
    return {k: arms[k]["step"] for k in TIMED_ARMS}, host_batches[0], train_launches


# ---------------------------------------------------------------- phase 7

FIT_RECORDS = 3200  # 2560 train, 320 dev, 320 test (random_split, seed 42)
FIT_BATCH = 32  # the reference recipe's batch size
# Two fit() trajectories cannot be held to each other: the kernels round
# differently from the plain ops (phase 6: 1e-7 to 1e-6 of a step's loss) and
# 80 Adam steps per epoch on these targets amplify any such difference, as
# the plain arm started from weights one f32 rounding up shows against
# itself. So the kernels are held to plain in lockstep instead: along the
# pallas_step f32 fit's own trajectory, a plain model on the SAME parameters
# recomputes every forward (predictions at MODEL_TOL) and every train step's
# gradients (TRAIN_TOL's f32 gradient bound) before the update. It runs under
# deterministic algorithms, as the other [fit] runs do, so that every call
# walks the same trajectory and a reading repeats (the readout's atomics
# would give each call a trajectory of its own).
EVAL_TOL = 1e-5  # evaluate_splits against metrics of a second predict (atomics in the readout)
LOCKSTEP_EPOCHS = 2


@contextlib.contextmanager
def deterministic():
    """Deterministic PyTorch algorithms (the readout's and the embedding
    backward's index_add_ without atomics); the CUDA kernels are so anyway."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def teacher_records(records, plan, teacher, key):
    """``records`` with ``key`` replaced by the teacher's predictions on the
    card, so a model of the same family can learn the targets."""
    from ionic_mpnn_torch.training import predict

    y = predict(teacher, records, plan)
    if not np.isfinite(y).all():
        raise AssertionError("teacher predictions are not finite")
    return [dict(r, **{key: float(v)}) for r, v in zip(records, y)]


def counted_fit(tag, model, cfg, tcfg, train, dev, plan, n_dev_batches, steps_before=0,
                optimizer=None):
    """``fit`` with the launch counters zeroed just before it and read just
    after: they must equal its train steps × the per-step launches plus its
    dev batches × epochs × the per-forward launches."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import fit

    per_step, per_fwd = kernel_launches(cfg.message_impl, cfg.scatter_impl)
    kernels.reset_launch_counts()
    res = fit(model, cfg, tcfg, train, dev, plan, optimizer=optimizer, verbose=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    epochs, steps = len(res.segments), res.steps - steps_before
    if steps < epochs * -(-len(train) // plan.batch_size):
        raise AssertionError(f"fit {tag}: {steps} train steps in {epochs} epochs")
    want = {k: steps * per_step.get(k, 0) + n_dev_batches * epochs * per_fwd.get(k, 0)
            for k in counts}
    if counts != want:
        raise AssertionError(f"fit {tag}: launch counts {counts}, expected {want}")
    for key in ("loss", "val_loss"):
        if not np.isfinite(res.history[key]).all():
            raise AssertionError(f"fit {tag}: {key} {res.history[key]}")
    for i, seg in enumerate(res.segments):
        epoch = res.epochs_run - epochs + i + 1
        log(f"[fit] {tag} epoch {epoch}: loss {res.history['loss'][epoch - 1]!r} val_loss "
            f"{res.history['val_loss'][epoch - 1]!r}, "
            + ", ".join(f"{k} {v:.4f} s" for k, v in seg.items())
            + f", epoch {res.history['epoch_seconds'][epoch - 1]:.4f} s")
    seconds = res.history["epoch_seconds"][-epochs:]
    summary = {"epochs": epochs, "train_steps": steps,
               "median_epoch_s": statistics.median(seconds),
               "train_steps_per_s": steps / sum(seconds),
               "segments_s": {k: sum(seg[k] for seg in res.segments) for k in res.segments[0]},
               "launches": counts, "history": res.history}
    log(f"[fit] {tag}: {steps} train steps, median epoch {summary['median_epoch_s']:.4f} s, "
        f"{summary['train_steps_per_s']:.3f} train steps/s inside fit(), launches {counts}")
    return res, summary


class Lockstep(torch.nn.Module):
    """A kernel model and a plain model sharing one set of parameters. Each
    forward returns the kernel model's output and measures the plain one's
    on the same weights and batch: the predictions' excess over MODEL_TOL
    (at most 1 passes) and, in training, plain's gradient of the train
    step's loss, which :class:`LockstepOptimizer` compares before the update.
    Every measurement and the forward counts are device tensors updated in
    place, so the checks run inside fit()'s CUDA graphs, replay after
    replay; they are read once, after fit()."""

    def __init__(self, kernel, plain, fp_l2):
        super().__init__()
        self.kernel, self.plain, self.fp_l2 = kernel, plain, fp_l2
        for name, p in kernel.named_parameters():
            path, _, leaf = name.rpartition(".")
            setattr(plain.get_submodule(path), leaf, p)
        self.params = list(kernel.parameters())
        self.plain_grads = None
        dev = self.params[0].device
        self.worst_t = {k: torch.zeros((), device=dev) for k in ("pred", "grad")}
        self.forwards_t = {k: torch.zeros((), dtype=torch.int64, device=dev)
                           for k in ("train", "eval")}
        # the train step (0-based) and the parameter of the worst gradient
        self.worst_grad_at_t = torch.zeros(2, dtype=torch.int64, device=dev)
        self.names = [name for name, _ in kernel.named_parameters()]

    @property
    def worst(self):
        return {k: v.item() for k, v in self.worst_t.items()}

    @property
    def forwards(self):
        return {k: int(v.item()) for k, v in self.forwards_t.items()}

    @property
    def worst_grad_at(self):
        step, j = (int(v) for v in self.worst_grad_at_t.tolist())
        return f"train step {step} (0-based), {self.names[j]}"

    def forward(self, batch):
        from ionic_mpnn_torch.training import data_loss, l2_penalty

        out = self.kernel(batch)
        if self.training:
            ref = self.plain(batch)
            loss = (data_loss(ref["pred"], batch.y, batch.sample_mask, "mse", 1.0)
                    + l2_penalty(self.plain, self.fp_l2))
            self.plain_grads = torch.autograd.grad(loss, self.params)
        else:
            ref = self.plain(batch)
        got, want = out["pred"].detach().float(), ref["pred"].detach().float()
        rtol, atol = MODEL_TOL
        excess = ((got - want).abs() / (atol + rtol * want.abs())).max()
        with torch.no_grad():
            torch.maximum(self.worst_t["pred"], excess, out=self.worst_t["pred"])
            self.forwards_t["train" if self.training else "eval"].add_(1)
        return out


def lockstep_optimizer(shadow, **kw):
    """The train step's optimizer, holding each gradient to the plain one of
    ``shadow`` (a :class:`Lockstep`) before it clips and updates."""
    from ionic_mpnn_torch.training import Optimizer

    class LockstepOptimizer(Optimizer):
        @torch.no_grad()
        def step(self):
            tol = TRAIN_TOL["float32"][0]
            excess = torch.stack([
                ((p.grad - want).abs()
                 / (tol * (want.abs() + want.abs().max())).clamp(min=1e-30)).max()
                for p, want in zip(shadow.params, shadow.plain_grads)])
            worst, j = excess.max(0)
            at = torch.stack([shadow.forwards_t["train"] - 1, j])
            shadow.worst_grad_at_t.copy_(
                torch.where(worst > shadow.worst_t["grad"], at, shadow.worst_grad_at_t))
            torch.maximum(shadow.worst_t["grad"], worst, out=shadow.worst_t["grad"])
            super().step()

    return LockstepOptimizer(shadow.parameters(), **kw)


def phase_fit():
    """fit() at full width on teacher targets, from the same weights: under
    deterministic algorithms plain gather f32, the same from weights one
    rounding up, pallas_step f32 (uninterrupted, a checkpoint every epoch)
    and the same stopped at epoch 2 and resumed to 4; pallas_step f32 in
    lockstep with plain, deterministic too; then, as users run it, the
    default-resolved configuration and gather with the pallas scatter."""
    import tempfile

    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.config import (TrainConfig, resolve_compute_dtype,
                                         resolve_message_impl, viscosity_config)
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import (evaluate_splits, mae, predict, r2_score,
                                           random_split)

    records, vocab = make_bench_dataset(FIT_RECORDS, seed=0)
    plan = plan_capacities(records, FIT_BATCH)  # on all records, as the CLI plans
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    with deterministic():  # the same targets in every run
        records = teacher_records(records, plan, ViscosityModel(base, seed=1), "log_eta")
    idx = random_split(len(records))
    train, dev_split, test = ([records[i] for i in part] for part in idx)
    n_dev = sum(1 for _ in iter_batches(dev_split, plan))
    log(f"[fit] {len(records)} records (teacher targets), train {len(train)}, dev "
        f"{len(dev_split)} ({n_dev} batches), test {len(test)}; batch {FIT_BATCH}, "
        f"cation N={plan.node_cap} E={plan.edge_cap}")
    state = ViscosityModel(base, seed=0).state_dict()

    def model_for(impl, scatter="xla", dtype="float32", rounding_up=False):
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict({k: v * (1 + 2 ** -23) if rounding_up else v
                               for k, v in state.items()})
        return model, cfg

    def tcfg(epochs, **kw):
        return TrainConfig(epochs=epochs, batch_size=FIT_BATCH, seed=0, **kw)

    runs, launches = {}, {}

    def run(tag, model_cfg, train_cfg, steps_before=0, optimizer=None):
        res, summary = counted_fit(tag, *model_cfg, train_cfg, train, dev_split, plan, n_dev,
                                   steps_before, optimizer)
        runs[tag] = summary
        for k, v in summary["launches"].items():
            launches[k] = launches.get(k, 0) + v
        return res

    def gap(a, b, key, epoch):
        return abs(a.history[key][epoch] / b.history[key][epoch] - 1)

    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        plain = run("gather f32 (plain, deterministic)", model_for("gather"), tcfg(2))
        control = run("gather f32, weights one rounding up (plain, deterministic)",
                      model_for("gather", rounding_up=True), tcfg(2))
        whole = run("pallas_step f32 (deterministic)", model_for("pallas_step"),
                    tcfg(4, checkpoint_dir=f"{tmp}/whole", checkpoint_every=1))
        first = run("pallas_step f32 (deterministic) resume, first 2",
                    model_for("pallas_step"),
                    tcfg(2, checkpoint_dir=f"{tmp}/resume", checkpoint_every=1))
        resumed = run("pallas_step f32 (deterministic) resume, epochs 3-4",
                      model_for("pallas_step"), tcfg(4, checkpoint_dir=f"{tmp}/resume"),
                      steps_before=first.steps)
    gaps = {f"{key} epoch {e + 1}": {"kernel": gap(whole, plain, key, e),
                                     "one_rounding": gap(control, plain, key, e)}
            for key in ("loss", "val_loss") for e in range(2)}
    log("[fit] trajectories, relative gap to plain gather f32 of pallas_step f32 (and of "
        "plain from weights one rounding up): "
        + ", ".join(f"{k} {v['kernel']:.3e} ({v['one_rounding']:.3e})"
                    for k, v in gaps.items()))
    runs["pallas_step f32 (deterministic)"]["gap_vs_plain"] = gaps

    kernel, cfg = model_for("pallas_step")
    shadow = Lockstep(kernel, model_for("gather")[0], cfg.fp_l2)
    t = tcfg(LOCKSTEP_EPOCHS)
    with deterministic():
        res = run("pallas_step f32 in lockstep with plain", (shadow, cfg), t,
                  optimizer=lockstep_optimizer(shadow, learning_rate=t.learning_rate,
                                               clipnorm=t.clipnorm))
    want = {"train": res.steps, "eval": n_dev * LOCKSTEP_EPOCHS}
    if shadow.forwards != want:
        raise AssertionError(f"lockstep: {shadow.forwards} forwards, expected {want}")
    if not all(v <= 1.0 for v in shadow.worst.values()):  # NaN fails too
        raise AssertionError(f"lockstep: kernel against plain on the same weights beyond "
                             f"tolerance (excess/bound): {shadow.worst}; worst gradient at "
                             f"{shadow.worst_grad_at}")
    log(f"[fit] lockstep, {LOCKSTEP_EPOCHS} epochs: {res.steps} train steps and "
        f"{want['eval']} dev forwards of pallas_step f32 against plain gather f32 on the "
        f"same weights; worst predictions {shadow.worst['pred']:.3e} of rtol/atol "
        f"{MODEL_TOL[0]}, worst gradient {shadow.worst['grad']:.3e} of "
        f"{TRAIN_TOL['float32'][0]}·(|want| + max|want|) at {shadow.worst_grad_at}")
    runs["pallas_step f32 in lockstep with plain"]["lockstep_worst"] = dict(shadow.worst)

    if (resumed.history["loss"][:2] != first.history["loss"][:2]
            or resumed.history["val_loss"][:2] != first.history["val_loss"][:2]):
        raise AssertionError("the resumed history does not start with the saved epochs")
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        if resumed.history[key] != whole.history[key]:
            raise AssertionError(f"resumed {key} {resumed.history[key]} is not the "
                                 f"uninterrupted run's {whole.history[key]}")
    for k, v in whole.params.items():
        if not torch.equal(v, resumed.params[k]):
            raise AssertionError(f"resumed best weights differ from the uninterrupted "
                                 f"run's in {k}")
    log("[fit] resumed at epoch 2 against uninterrupted: loss, val_loss, "
        "dead_fp_cat_frac and the best weights equal, bit for bit")

    impl, dtype = resolve_message_impl("auto"), resolve_compute_dtype("auto")
    if (impl, dtype) != ("pallas_step", "bfloat16"):
        raise AssertionError(f"auto resolves to {impl} {dtype} on the card")
    model, _ = model_for(impl, dtype=dtype)
    default = run(f"default ({impl} {dtype})", (model, model.cfg), tcfg(4))
    losses = default.history["loss"]
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"fit default: the last epoch's loss {losses[-1]!r} is not "
                             f"below half the first's {losses[0]!r}")
    splits = {"train": train, "dev": dev_split, "test": test}
    metrics = evaluate_splits(model, splits, plan, default.normalizer)
    for name, part in splits.items():
        y = np.asarray([r["log_eta"] for r in part], np.float32)
        pred = default.normalizer.inverse(predict(model, part, plan))
        want = {"r2": r2_score(y, pred), "mae": mae(y, pred)}
        for k, v in want.items():
            got = metrics[name][k]
            if not (np.isfinite(got) and abs(got - v) <= EVAL_TOL * (1 + abs(v))):
                raise AssertionError(f"evaluate_splits {name} {k} {got!r} vs {v!r}")
    log("[fit] default evaluate_splits: " + json.dumps(metrics))
    runs[f"default ({impl} {dtype})"]["evaluate_splits"] = metrics
    run("gather+pallas scatter f32", model_for("gather", "pallas"), tcfg(1))

    def one_epoch_fit():
        """A one-epoch fit() of the default configuration, its model built
        now, so the call holds nothing but fit()."""
        from ionic_mpnn_torch.training import fit

        model, cfg = model_for(impl, dtype=dtype)
        return lambda: fit(model, cfg, tcfg(1), train, dev_split, plan, verbose=False)

    fit_data = {"records": records, "vocab": vocab, "train": train, "dev": dev_split,
                "plan": plan,
                "n_dev": n_dev, "model_for": model_for, "tcfg": tcfg, "first": first,
                "default": runs[f"default ({impl} {dtype})"], "run": run}
    return runs, launches, one_epoch_fit, fit_data


def fit_busy_share(one_epoch_fit):
    """A one-epoch fit() of the default configuration under the profiler
    (after every timed run: the profiler slows later host work): the card's
    busy time and its share of the same span's wall time, the whole fit()
    call up to the card's last kernel (the dev upload, the epoch, the dev
    eval, the best-weight clones and their restore)."""
    call, box = one_epoch_fit(), {}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["res"] = call()
        torch.cuda.synchronize()
        box["wall_ms"] = 1e3 * (time.perf_counter() - t0)

    prof = device_profile(timed, n=1, warmup=0)
    res, wall_ms = box["res"], box["wall_ms"]
    out = {"wall_ms": wall_ms, "epoch_ms": 1e3 * res.history["epoch_seconds"][0],
           "busy_ms": prof["busy_ms"], "train_steps": res.steps,
           "busy_share": prof["busy_ms"] / wall_ms,
           "top": {k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]}}
    log(f"[fit] default configuration, one-epoch fit() call under the profiler: wall "
        f"{wall_ms:.2f} ms (its epoch {out['epoch_ms']:.2f} ms), device "
        f"busy {out['busy_ms']:.2f} ms (busy share {out['busy_share']:.4f}, "
        f"{out['busy_ms'] / res.steps:.4f} ms per train step); top kernels ms: "
        + json.dumps({k: round(v, 3) for k, v in out["top"].items()}))
    return out


@contextlib.contextmanager
def eager_steps():
    """fit() with its train and eval steps eager, as JAX's
    ``jit_compile=False``: the step factories that fit() calls, patched in
    this process (fit() itself takes no such parameter)."""
    import functools

    import ionic_mpnn_torch.training.loop as loop

    train, evaluate = loop.make_train_step, loop.make_eval_step
    loop.make_train_step = functools.partial(train, jit_compile=False)
    loop.make_eval_step = functools.partial(evaluate, jit_compile=False)
    try:
        yield
    finally:
        loop.make_train_step, loop.make_eval_step = train, evaluate


def same_fit(tag, a, b):
    """Two fit() results equal bit for bit: history and best weights."""
    keys = set(a.history) - {"epoch_seconds"}
    if keys != set(b.history) - {"epoch_seconds"} or "loss" not in keys:
        raise AssertionError(f"{tag}: history keys {sorted(a.history)} / {sorted(b.history)}")
    for key in sorted(keys):
        if a.history[key] != b.history[key]:
            raise AssertionError(f"{tag}: {key} {a.history[key]} != {b.history[key]}")
    if a.steps != b.steps or a.best_val_loss != b.best_val_loss:
        raise AssertionError(f"{tag}: steps / best val_loss {a.steps} {a.best_val_loss!r} != "
                             f"{b.steps} {b.best_val_loss!r}")
    bad = [k for k, v in a.params.items() if not torch.equal(v, b.params[k])]
    if bad:
        raise AssertionError(f"{tag}: best weights differ in {bad[:5]}")


def epoch_summary(res):
    """Median epoch seconds, train steps/s and the dispatch share of the
    epochs after the first (the first holds the captures)."""
    later = range(1, len(res.segments)) if len(res.segments) > 1 else range(1)
    secs = [res.history["epoch_seconds"][-len(res.segments) + i] for i in later]
    disp = [res.segments[i]["dispatch"] for i in later]
    steps_per_epoch = res.steps / res.epochs_run
    return {"epoch_s": statistics.median(secs), "first_epoch_s": res.history["epoch_seconds"][
        -len(res.segments)], "train_steps_per_s": steps_per_epoch * len(secs) / sum(secs),
        "dispatch_s": statistics.median(disp), "dispatch_share": sum(disp) / sum(secs),
        "loader": res.loader, "steps_per_call": res.steps_per_call}


# arms of [graphs]: (name, message_impl, scatter_impl, compute_dtype, plan)
GRAPH_ARMS = [
    ("pallas_step f32", "pallas_step", "xla", "float32", "sorted"),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "sorted"),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "sorted"),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "sorted"),
    ("gather f32 (plain)", "gather", "xla", "float32", "sorted"),
    ("onehot f32 aligned", "onehot", "xla", "float32", "aligned"),
]
GRAPH_BATCH = 512  # three batches of records[:1536], and a remainder of two
GRAPH_K = 3
GRAPH_TIMED_K = 8  # the default K: 8 distinct packings of the bench batch
DROPOUT = 0.3
CARD = "cuda"


def optimizer_state(step):
    o = step.optimizer
    return ([p.detach().clone() for p in o.params], [m.clone() for m in o.mu],
            [v.clone() for v in o.nu], int(o.count))


def replay_kernels(launches):
    """A graph's launches per replay as kernel_records counts them: the
    four wrappers' (the dh share and the designs' counts are parts of
    those)."""
    return {k: launches[k] for k in ("sorted_segment_sum", "fused_message_aggregate",
                                     "fused_mp_step", "fused_message_table_grad")}


def kernel_records(fn):
    """Our kernels' launches in the card's own records (torch.profiler) of
    one call of ``fn``, by wrapper name: a fused kernel with the GRU
    epilogue is a fused_mp_step launch, without it a
    fused_message_aggregate launch (the backward's dh included); a table
    gradient's bucket kernel a fused_message_table_grad call, whose sum of
    the parts must run as often."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"sorted_segment_sum": 0, "fused_message_aggregate": 0, "fused_mp_step": 0,
              "fused_message_table_grad": 0}
    sums = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if TABLE_GRAD_KERNEL in e.name:
            counts["fused_message_table_grad"] += 1
        elif "table_grad_sum_kernel" in e.name:
            sums += 1
        elif "segment_sum_kernel" in e.name:
            counts["sorted_segment_sum"] += 1
        elif any(k in e.name for k in PRODUCT_KERNELS):
            # kGru, the template's second argument, tells the step
            counts["fused_mp_step" if re.search(r"\btrue\b", e.name)
                   else "fused_message_aggregate"] += 1
    if sums != counts["fused_message_table_grad"]:
        raise AssertionError(f"the card ran {counts['fused_message_table_grad']} table-gradient "
                             f"bucket kernels and {sums} sums of their parts")
    return counts


def phase_graphs(records, vocab, fit_data, state):
    """CUDA graphs against the eager path, under deterministic algorithms:
    per arm the same 8 train steps (groups of 3, 3 and a remainder of 2)
    eagerly, as one-step replays and through the K = 3 graph, bit for bit;
    fit() of pallas_step f32 with K = 8, K = 1 and eager; the transfer
    model's stage 2 with dropout; then times, graphed against eager, in this
    call. Returns its results, its launches and the profiler's part, which
    runs last."""
    from ionic_mpnn_torch.benchmarks.harness import _count_message_edges, _time_calls
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.data.loader import plan_template
    from ionic_mpnn_torch.data.packing import StaticBatches
    from ionic_mpnn_torch.models import (TransferMPModel, ViscosityModel, load_trunk_params,
                                         transfer_stage_labels)
    from ionic_mpnn_torch.models.layers import Dropout
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import fit, make_partitioned_optimizer, make_train_step
    from ionic_mpnn_torch.training.graphs import Replay

    t_phase = time.perf_counter()
    out, launches = {"steps": {}}, {}
    head = records[:GRAPH_K * GRAPH_BATCH]
    # headroom 2 so the records pack as three (nearly) full batches
    plans = {"sorted": plan_capacities(head, GRAPH_BATCH, headroom=2.0),
             "aligned": plan_capacities(head, GRAPH_BATCH, headroom=2.0,
                                        edge_layout="window_aligned")}
    host = {k: list(iter_batches(head, p))[:GRAPH_K] for k, p in plans.items()}
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    kept = {}
    with deterministic():
        for name, impl, scatter, dtype, plan_tag in GRAPH_ARMS:
            b = host[plan_tag]
            if len(b) != GRAPH_K:
                raise AssertionError(f"[graphs] {len(b)} batches of {GRAPH_BATCH}")
            groups = [b, b, b[:2]]
            cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
            per_step = kernel_launches(impl, scatter)[0]
            runs = {}
            for mode, k, jit in (("eager", GRAPH_K, False), ("one-step replays", 1, True),
                                 ("K = 3 graph", GRAPH_K, True)):
                model = ViscosityModel(cfg, seed=0)
                model.load_state_dict(state)
                step = make_train_step(model, cfg, TrainConfig(steps_per_call=k),
                                       jit_compile=jit)
                kernels.reset_launch_counts()
                losses = [step.run(grp) if k > 1 else torch.cat([step.run([x]) for x in grp])
                          for grp in groups]
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                want = {kk: 8 * per_step.get(kk, 0) for kk in counts}
                if counts != want:
                    raise AssertionError(f"[graphs] {name} {mode}: launches {counts}, "
                                         f"expected {want}")
                for kk, v in counts.items():
                    launches[kk] = launches.get(kk, 0) + v
                runs[mode] = (torch.cat(losses).cpu(), optimizer_state(step), step)
            ref_losses, (ref_p, ref_mu, ref_nu, ref_count), _ = runs["eager"]
            for mode in ("one-step replays", "K = 3 graph"):
                losses, (p, mu, nu, count), _ = runs[mode]
                diff = ([f"loss"] if not torch.equal(losses, ref_losses) else [])
                diff += [f"param {i}" for i, (x, y) in enumerate(zip(p, ref_p))
                         if not torch.equal(x, y)]
                diff += [f"mu {i}" for i, (x, y) in enumerate(zip(mu, ref_mu))
                         if not torch.equal(x, y)]
                diff += [f"nu {i}" for i, (x, y) in enumerate(zip(nu, ref_nu))
                         if not torch.equal(x, y)]
                if count != ref_count or count != 8:
                    diff.append(f"count {count} vs {ref_count}")
                if diff:
                    raise AssertionError(f"[graphs] {name}: {mode} differ from eager in "
                                         f"{diff[:6]}")
            out["steps"][name] = {"losses": ref_losses.tolist(), "launches_per_step": per_step}
            log(f"[graphs] {name} ({plan_tag}, batch {GRAPH_BATCH}): 8 train steps eager, as "
                f"one-step replays and through the K = {GRAPH_K} graph (groups 3, 3, remainder "
                f"2): losses, {len(ref_p)} parameters, both moments and the count (8) equal "
                f"bit for bit; launches exact ({per_step} per step); losses "
                f"{[round(x, 6) for x in ref_losses.tolist()]}")
            if name in ("pallas_step f32", "gather+pallas scatter f32"):
                kept[name] = (runs["K = 3 graph"][2], b)

    # fit(): K = 8 (the default), K = 1 and eager, from the same weights
    fd = fit_data
    with deterministic():
        k1 = fd["run"]("pallas_step f32 (deterministic) K = 1", fd["model_for"]("pallas_step"),
                       fd["tcfg"](2, steps_per_call=1))
        with eager_steps():
            eager = fd["run"]("pallas_step f32 (deterministic) eager",
                              fd["model_for"]("pallas_step"), fd["tcfg"](2))
    fd["k1"] = k1
    first = fd["first"]
    if (first.steps_per_call, k1.steps_per_call) != (8, 1):
        raise AssertionError(f"[graphs] K {first.steps_per_call} / {k1.steps_per_call}")
    same_fit("[graphs] fit K = 1 against K = 8", k1, first)
    same_fit("[graphs] fit eager against K = 8", eager, first)
    log(f"[graphs] fit() pallas_step f32, 2 epochs, deterministic: K = 8 (graphs), K = 1 "
        f"(graphs) and eager: loss {first.history['loss']}, val_loss "
        f"{first.history['val_loss']}, dead_fp_cat_frac and best weights equal bit for bit "
        f"(the graphed resume and the lockstep are [fit]'s)")
    out["fit"] = {"K=8": epoch_summary(first), "K=1": epoch_summary(k1),
                  "eager": epoch_summary(eager)}

    # the transfer model's stage 2 with dropout: masks change from replay
    # to replay, and two graphed fits from one seed repeat
    tr = [dict(r, mp=r["log_eta"]) for r in fd["records"][:640]]
    tplan = plan_capacities(tr, FIT_BATCH, with_temperature=False, target_key="mp")
    tcfg_ = base.replace(head="transfer", transfer_dropout=DROPOUT, message_impl="pallas_step")

    def transfer_model():
        model = TransferMPModel(tcfg_, seed=0)
        load_trunk_params(model, state)
        return model

    model = transfer_model()
    drop = next(m for m in model.modules() if isinstance(m, Dropout) and m.rate == DROPOUT)
    drop.manual_seed(5)
    seen = {}

    def keep(mod, inputs, output):
        with torch.no_grad():
            if "mask" not in seen:
                seen["mask"] = torch.zeros(output.shape, dtype=torch.bool, device=output.device)
            seen["mask"].copy_(output != 0)

    hook = drop.register_forward_hook(keep)
    step = make_train_step(model, tcfg_, TrainConfig(loss="huber", steps_per_call=1),
                           make_partitioned_optimizer(model, transfer_stage_labels(model, 2),
                                                      1e-4))
    tb = next(iter_batches(tr, tplan))
    masks = []
    with deterministic():
        for _ in range(4):  # the first call runs eagerly, then three replays
            step(tb)
            masks.append(seen["mask"].clone())
    hook.remove()
    if any(torch.equal(masks[i], masks[i + 1]) for i in range(3)):
        raise AssertionError("[graphs] dropout: two consecutive steps drew the same mask")
    keep_frac = [float(m.float().mean()) for m in masks]
    fits = []
    with deterministic():  # the readout's index_add_ without atomics
        for _ in range(2):
            model = transfer_model()
            fits.append(fit(model, tcfg_, TrainConfig(
                loss="huber", huber_delta=1.0, epochs=2, batch_size=FIT_BATCH, normalize_y=True,
                normalize_guard="eps", learning_rate=1e-4, seed=0), tr[:512], tr[512:], tplan,
                optimizer=make_partitioned_optimizer(model, transfer_stage_labels(model, 2),
                                                     1e-4), verbose=False))
    same_fit("[graphs] transfer stage 2 with dropout, two graphed fits", fits[0], fits[1])
    log(f"[graphs] transfer stage 2, dropout {DROPOUT}: 4 steps (1 eager, 3 replays) drew 4 "
        f"different masks (kept {[round(x, 4) for x in keep_frac]} of the units); two graphed "
        f"fits (K = {fits[0].steps_per_call}, 2 epochs, seed 0) equal bit for bit: loss "
        f"{fits[0].history['loss']}")
    out["dropout"] = {"kept": keep_frac, "fit_loss": fits[0].history["loss"]}

    # times, graphed against eager, batch 2048: the K = 8 step over 8
    # distinct packings of the bench batch, as the bench runs it
    bplan = plan_capacities(records, BATCH, headroom=2.0)
    hb = [next(iter_batches(records[:BATCH], bplan, shuffle=True, seed=s))
          for s in range(GRAPH_TIMED_K)]
    me = int(np.mean([_count_message_edges(b, base.num_steps) for b in hb]))
    cfg = base.replace(message_impl="pallas_step", compute_dtype="bfloat16")
    timed, calls = {}, {}
    for mode, jit in (("graphed", True), ("eager", False)):
        model = ViscosityModel(cfg, seed=0)
        step = make_train_step(model, cfg, TrainConfig(steps_per_call=GRAPH_TIMED_K),
                               jit_compile=jit)
        g = step.graphs(hb[0])
        g.slots.copy_into(hb)
        call = (lambda s=step, g=g: s.run_slots(g, GRAPH_TIMED_K)[:, 0])
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        r = _time_calls(call, torch.device(CARD), GRAPH_TIMED_K, me, BATCH, iters=10,
                        warmup=2, sync_each=True)
        r["wall_ms"] = r["call_ms"] / GRAPH_TIMED_K
        r["memory_peak_above_base_mb"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        timed[mode], calls[mode] = r, call
        log(f"[graphs] train step pallas_step bf16, batch {BATCH}, {mode} (K = "
            f"{GRAPH_TIMED_K} per call): wall {r['wall_ms']:.4f} ms per step (a call "
            f"{r['call_ms']:.4f} ms, median of 10), host {r['host_ms']:.4f} ms to enqueue a "
            f"step, {r['edges_per_s']:.6e} message-edges/s, peak memory "
            f"{r['memory_peak_above_base_mb']:.1f} MiB above {base_mem / 2**20:.1f} MiB")
    out["train_step"] = timed

    # the forward of predict per batch of 2048: its graph's replay against eager
    fwd_model = ViscosityModel(cfg, seed=0)
    fwd_model.eval()
    slots = StaticBatches(plan_template(bplan), 1, CARD)
    slots.copy_into([hb[0]])

    def forward():
        with torch.inference_mode():
            return fwd_model(slots.batches[0])["pred"]

    replay = Replay(forward, CARD, True, torch.cuda.graph_pool_handle())
    out["forward"] = {"graphed": forward_times(replay), "eager": forward_times(forward)}
    log(f"[graphs] predict's forward, pallas_step bf16, per batch of {BATCH} (CUDA events, "
        f"median of 50): " + json.dumps(out["forward"]))
    # fit() epochs of the default configuration, graphed ([fit]'s run) and eager
    with eager_steps():
        m, c = fd["model_for"]("pallas_step", dtype="bfloat16")
        eager_default = fd["run"]("default (pallas_step bfloat16) eager", (m, c), fd["tcfg"](2))
    default = fd["default"]
    out["fit_default"] = {"graphed": {k: default[k] for k in ("median_epoch_s",
                                                              "train_steps_per_s",
                                                              "segments_s")},
                          "eager": epoch_summary(eager_default)}
    log("[graphs] fit() default configuration at batch 32: " + json.dumps(out["fit_default"]))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[graphs] checks and wall-clock timings in {out['seconds']:.1f} s")

    def profile():
        """The card's records: kernels per replayed group against the
        capture's count, and the timed steps' busy time."""
        for name, (step, b) in kept.items():
            g = step.graphs(b[0])
            got = kernel_records(lambda: step.run(b))
            want = replay_kernels(g.group.launches)
            if got != want:
                raise AssertionError(f"[graphs] {name}: the profiler saw {got} kernels in "
                                     f"one replay of the K = {GRAPH_K} graph, the capture "
                                     f"counted {want}")
            log(f"[graphs] {name}: one replay of the K = {GRAPH_K} graph ran {got} of our "
                f"kernels in the card's records, as its capture counted")
        for mode, call in calls.items():
            prof = device_profile(call, n=3, warmup=1)
            t = timed[mode]
            busy = prof["busy_ms"] / GRAPH_TIMED_K
            t.update(busy_ms=busy, idle_share=max(0.0, 1 - busy / t["wall_ms"]))
            log(f"[graphs] train step pallas_step bf16 {mode}: device busy {busy:.4f} ms per "
                f"step, idle share {t['idle_share']:.3f} of its {t['wall_ms']:.4f} ms wall")
        return out

    return out, launches, profile


# ---------------------------------------------------------------- [native]

def phase_native(fit_data, graphs_k1):
    """The port's C++ packer on the card machine: built with g++, its
    batches equal to the Python packer's in every layout, and fit() with
    it equal to fit() with the Python packer, K = 8 (group mode) and K = 1."""
    from ionic_mpnn_torch import native
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.data.columnar import ColumnarIonPairs, iter_batches_fast
    from ionic_mpnn_torch.data.packing import _batch_arrays

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("[native] the C++ packer did not build (no g++?)")
    lib = Path(native.get_packer_lib()._name)
    log(f"[native] g++ {shutil.which('g++')}: {lib.name} loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    recs = fit_data["records"]
    data = ColumnarIonPairs.from_records(recs)
    layouts = {}
    for name, kw in (("sorted", {}), ("window", {"edge_layout": "window"}),
                     ("window_aligned", {"edge_layout": "window_aligned"}),
                     ("balanced", {"edge_layout": "window_aligned", "balance": True})):
        plan = plan_capacities(recs, FIT_BATCH, **kw)
        t0 = time.perf_counter()
        py = list(iter_batches(recs, plan, shuffle=True, seed=1))
        t_py = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = list(iter_batches_fast(data, plan, shuffle=True, seed=1))
        t_nat = time.perf_counter() - t0
        if len(py) != len(nat):
            raise AssertionError(f"[native] {name}: {len(nat)} batches, Python {len(py)}")
        for a, b in zip(py, nat):
            A, B = _batch_arrays(a), _batch_arrays(b)
            if A.keys() != B.keys() or any(not np.array_equal(A[k], B[k]) for k in A):
                raise AssertionError(f"[native] {name}: a batch differs from the Python "
                                     f"packer's")
        layouts[name] = {"batches": len(py), "python_s": t_py, "native_s": t_nat}
        log(f"[native] {name}: {len(py)} batches of {FIT_BATCH} over {len(recs)} records equal "
            f"array for array; packing {t_py:.4f} s in Python, {t_nat:.4f} s native")
    fd = fit_data
    with deterministic():
        py8 = fd["run"]("pallas_step f32 (deterministic) Python loader K = 8",
                        fd["model_for"]("pallas_step"), fd["tcfg"](2, use_native_loader=False))
        py1 = fd["run"]("pallas_step f32 (deterministic) Python loader K = 1",
                        fd["model_for"]("pallas_step"),
                        fd["tcfg"](2, use_native_loader=False, steps_per_call=1))
    nat8 = fd["first"]
    for tag, nat, py in (("K = 8", nat8, py8), ("K = 1", graphs_k1, py1)):
        if (nat.loader, py.loader) != ("native", "python"):
            raise AssertionError(f"[native] {tag}: loaders {nat.loader} / {py.loader}")
        same_fit(f"[native] fit {tag}, native against Python loader", nat, py)
    fits = {f"{loader} K = {r.steps_per_call}": epoch_summary(r)
            for loader, r in (("native", nat8), ("python", py8), ("native", graphs_k1),
                              ("python", py1))}
    log("[native] fit() with the native loader equals the Python loader bit for bit, K = 8 "
        "(group mode) and K = 1; dispatch per epoch: "
        + json.dumps({k: round(v["dispatch_s"], 4) for k, v in fits.items()}))
    out = {"library": lib.name, "layouts": layouts, "fit": fits,
           "seconds": time.perf_counter() - t_phase}
    log(f"[native] phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 8

def phase_mp(records, plan, vocab):
    """The melting-point model at full width (bond_dim 1024): predict over
    the three bench batches in pallas_step f32 against plain gather f32,
    then 2 epochs of fit(normalize_y=True) on teacher targets."""
    from ionic_mpnn_torch.config import TrainConfig, melting_point_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import MeltingPointModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import Normalizer, predict, random_split

    base = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    plain = MeltingPointModel(base, seed=0)
    kernel = MeltingPointModel(base.replace(message_impl="pallas_step"), seed=0)
    kernel.load_state_dict(plain.state_dict())
    want = predict(plain, records, plan)
    kernels.reset_launch_counts()
    got = predict(kernel, records, plan)
    counts = kernels.launch_counts()
    per_fwd = kernel_launches("pallas_step", "xla")[1]
    expect = {k: N_BATCHES * per_fwd.get(k, 0) for k in counts}
    if counts != expect:
        raise AssertionError(f"mp predict: launch counts {counts}, expected {expect}")
    err = close("mp predict pallas_step f32", torch.from_numpy(got), torch.from_numpy(want),
                *MODEL_TOL)
    log(f"[mp] bond_dim {base.bond_dim}: predict over {len(records)} records in "
        f"{N_BATCHES} batches, fused_mp_step launched {counts['fused_mp_step']} times, "
        f"pred max|err| {err:.3e} vs plain gather f32 (rtol/atol {MODEL_TOL[0]})")
    launches = dict(counts)

    # the bench records carry no melting point: a placeholder until the teacher's
    fit_records = [dict(r, mp=0.0) for r in records[:FIT_RECORDS]]
    mp_plan = plan_capacities(fit_records, FIT_BATCH, with_temperature=False, target_key="mp")
    fit_records = teacher_records(fit_records, mp_plan, MeltingPointModel(base, seed=1), "mp")
    idx = random_split(len(fit_records))
    train, dev_split = ([fit_records[i] for i in part] for part in idx[:2])
    n_dev = sum(1 for _ in iter_batches(dev_split, mp_plan))
    cfg = base.replace(message_impl="pallas_step")
    model = MeltingPointModel(cfg, seed=0)
    model.load_state_dict(plain.state_dict())
    res, summary = counted_fit("mp pallas_step f32, normalize_y", model, cfg,
                               TrainConfig(epochs=2, batch_size=FIT_BATCH, seed=0,
                                           normalize_y=True),
                               train, dev_split, mp_plan, n_dev)
    want_norm = Normalizer.fit(np.asarray([r["mp"] for r in train], np.float32))
    if res.normalizer != want_norm:
        raise AssertionError(f"mp normalizer {res.normalizer} is not the train split's "
                             f"{want_norm}")
    log(f"[mp] normalizer {res.normalizer} (fitted on the {len(train)} train records)")
    for k, v in summary["launches"].items():
        launches[k] += v
    return {"predict_max_abs_err": err, "fit": summary}, launches


# ---------------------------------------------------------------- phase 9

BENCH_RUNS = (  # (arguments, what the line must hold)
    ([], "host"),
    (["--message-impl", "onehot", "--no-baseline"], "paired"),
)


def phase_bench():
    """``python -m ionic_mpnn_torch.bench --repeats 1`` in a process of its
    own: with its defaults (the host harness, the dense baseline's
    ``vs_baseline`` and the H100 roofline's ``mfu`` and
    ``hbm_bound_fraction``, mfu at most 1), then with onehot, which must
    take the paired harness."""
    out = {}
    for extra, harness in BENCH_RUNS:
        cmd = [sys.executable, "-m", "ionic_mpnn_torch.bench", "--repeats", "1", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"bench exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        res = json.loads(line)
        value = res.get("value")
        if (res.get("metric") != "message_edges_per_s_fwd_bwd"
                or not (isinstance(value, (int, float)) and np.isfinite(value) and value > 0)
                or res.get("harness") != harness):
            raise AssertionError(f"bench printed {line}")
        if not 0 < res.get("mfu", -1) <= 1 or not 0 <= res.get("hbm_bound_fraction", -1) <= 1:
            raise AssertionError(f"bench roofline fields: {line}")
        if "--no-baseline" not in extra and not res.get("vs_baseline", 0) > 0:
            raise AssertionError(f"bench without vs_baseline: {line}")
        log(f"[bench] {' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} s: {line}")
        out[" ".join(extra) or "default"] = res
    return out


# ---------------------------------------------------------------- phase 10

# serving arms of [onehot]: (name, plan, model overrides, plain reference,
# tolerance, kernel per forward or None)
ONEHOT_SERVE = [
    ("onehot f32 vloop", "aligned f32", {"message_impl": "onehot", "onehot_select": "vloop"},
     "gather f32", MODEL_TOL, None),
    ("onehot f32 lanes", "aligned f32", {"message_impl": "onehot", "onehot_select": "lanes"},
     "gather f32", MODEL_TOL, None),
    ("onehot f32 basis", "aligned f32", {"message_impl": "onehot", "onehot_select": "basis"},
     "gather f32", MODEL_TOL, None),
    ("onehot bf16", "aligned bf16", {"message_impl": "onehot", "compute_dtype": "bfloat16"},
     "gather bf16, onehot roundings", BF16_MODEL_TOL, None),
    ("onehot f32 halo", "window f32", {"message_impl": "onehot"}, "gather f32", MODEL_TOL,
     None),
    ("onehot f32 balanced", "balanced f32", {"message_impl": "onehot"}, "gather f32",
     MODEL_TOL, None),
    ("pallas_step f32 aligned", "aligned f32", {"message_impl": "pallas_step"}, "gather f32",
     MODEL_TOL, "fused_mp_step"),
    ("pallas_step bf16 aligned", "aligned f32",
     {"message_impl": "pallas_step", "compute_dtype": "bfloat16"}, "gather f32, bf16-rounded",
     MODEL_TOL, "fused_mp_step"),
]
# training arms of [onehot]: (name, plan, model overrides, plain arm or None)
ONEHOT_TRAIN = [
    ("gather f32 aligned (plain)", "aligned f32", {}, None),
    ("gather f32 aligned, bf16-rounded (plain)", "aligned f32", {"round": "weights"}, None),
    ("gather bf16 aligned, onehot roundings (plain)", "aligned bf16",
     {"compute_dtype": "bfloat16", "round": "onehot"}, None),
    ("onehot f32 vloop", "aligned f32", {"message_impl": "onehot", "onehot_select": "vloop"},
     "gather f32 aligned (plain)"),
    ("onehot f32 vloop, remat", "aligned f32",
     {"message_impl": "onehot", "onehot_select": "vloop", "remat_message": True},
     "gather f32 aligned (plain)"),
    ("onehot bf16", "aligned bf16", {"message_impl": "onehot", "compute_dtype": "bfloat16"},
     "gather bf16 aligned, onehot roundings (plain)"),
    ("pallas_step f32 aligned", "aligned f32", {"message_impl": "pallas_step"},
     "gather f32 aligned (plain)"),
    ("pallas_step bf16 aligned", "aligned f32",
     {"message_impl": "pallas_step", "compute_dtype": "bfloat16"},
     "gather f32 aligned, bf16-rounded (plain)"),
]
ONEHOT_TIMED = ("onehot f32 vloop", "onehot bf16", "pallas_step bf16 aligned")
REMAT_TOL = 1e-5  # remat's first gradients against the same arm without it
ONEHOT_FIT_EPOCHS = 2


def layout_stats(tag, plan, records):
    """A window plan's batches over ``records``, and per side the node and
    edge capacity, the windows nw, the tile T and the tile fill (real edges
    over nw·T, over every batch)."""
    from ionic_mpnn_torch.data import iter_batches

    batches = list(iter_batches(records, plan))
    out = {"batches": len(batches), "window": plan.window}
    for side in ("cation", "anion"):
        g = getattr(batches[0], side)
        N, E = g.node_capacity, g.edge_capacity
        nw = N // plan.window
        real = sum(int(getattr(b, side).edge_mask.sum()) for b in batches)
        out[side] = {"N": N, "E": E, "nw": nw, "T": E // nw,
                     "fill": real / (len(batches) * E)}
    log(f"[onehot] plan {tag} ({plan.edge_layout}, window {plan.window}"
        f"{', balanced' if plan.balance else ''}): {len(batches)} batches; "
        + "; ".join(f"{side} N={out[side]['N']} E={out[side]['E']} nw={out[side]['nw']} "
                    f"T={out[side]['T']} fill {out[side]['fill']:.4f}"
                    for side in ("cation", "anion")))
    return out, batches


def forward_times(fn, n=50):
    """Median wall time (CUDA events) and host time (the clock at the call's
    return) of one call, the card idle before each."""
    for _ in range(5):
        fn()
    wall, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        b.record()
        b.synchronize()
        wall.append(a.elapsed_time(b))
    return {"wall_ms": statistics.median(wall), "host_ms": statistics.median(host)}


def phase_onehot(records, sorted_plan, vocab, state, dev, fit_data):
    """The JAX package's accelerator default, the one-hot message
    formulation on window_aligned batches, and the other window layouts:
    serving, train steps and fit() held against plain gather on the same
    batches, then wall and host times. Returns the results, the kernel
    launches of its driven paths, and a function that takes the profiler's
    readings (called after every wall-clock timing of the script).
    ``sorted_plan`` is [data]'s plan."""
    from ionic_mpnn_torch.config import (TrainConfig, edge_layout_for, resolve_onehot_window,
                                         viscosity_config)
    from ionic_mpnn_torch.benchmarks import time_train_step
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import predict

    t_phase = time.perf_counter()
    layout = edge_layout_for("onehot")
    w32, w16 = resolve_onehot_window("float32"), resolve_onehot_window("bfloat16")
    if (layout, w32, w16) != ("window_aligned", 128, 64):
        raise AssertionError(f"onehot plans {layout} with windows {w32} / {w16}")
    plans = {  # headroom 2, as the sorted plan of [data]
        "aligned f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                       window=w32),
        "aligned bf16": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                        window=w16),
        "window f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout="window",
                                      window=w32),
        "balanced f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                        window=w32, balance=True),
    }
    stats, host = {}, {}
    for tag, plan in plans.items():
        stats[tag], host[tag] = layout_stats(tag, plan, records)
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)

    def model_for(plan_tag, overrides):
        kw = {k: v for k, v in overrides.items() if k != "round"}
        cfg = base.replace(onehot_window=plans[plan_tag].window, **kw)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        if overrides.get("round") == "weights":
            round_in_every_forward(model)
        elif overrides.get("round") == "onehot":
            use_onehot_roundings(model)
        return model, cfg

    # the CUDA kernels on window-tiled batches (masked self-loop pads at
    # each window's last node) against their plain versions
    gen = torch.Generator().manual_seed(4)
    g = host["aligned f32"][0].cation.to(dev)
    V = vocab.bond_vocab_size + 1
    m_table = (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev)
    gru = gru_params(gen, 32, dev)
    h32 = torch.randn(g.node_capacity, 32, generator=gen).to(dev)
    kernel_errs = {}
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        kernel_errs[str(dt)[6:]] = check_kernels(
            f"window_aligned cation N={g.node_capacity} E={g.edge_capacity} h {str(dt)[6:]}",
            h32.to(dt), m_table, gru, g.bond_ids, g.src, g.dst, g.edge_mask, g.node_capacity,
            tol)

    # serving: every arm against plain gather on the same batches
    refs, serve, launches = {}, {}, {}

    def reference(plan_tag, kind):
        if (plan_tag, kind) not in refs:
            overrides = {"gather f32": {},
                         "gather bf16, onehot roundings": {"compute_dtype": "bfloat16",
                                                           "round": "onehot"},
                         "gather f32, bf16-rounded": {"round": "weights"}}[kind]
            model, _ = model_for(plan_tag, overrides)
            kernels.reset_launch_counts()
            with deterministic():  # no atomics in the reference's sums
                pred = predict(model, records, plans[plan_tag])
            if any(kernels.launch_counts().values()):
                raise AssertionError(f"plain path launched kernels: {kernels.launch_counts()}")
            if pred.shape != (len(records),) or not np.isfinite(pred).all():
                raise AssertionError("plain predictions are not finite of the right shape")
            refs[(plan_tag, kind)] = pred
        return refs[(plan_tag, kind)]

    for name, plan_tag, overrides, ref, tol, kernel in ONEHOT_SERVE:
        model, _ = model_for(plan_tag, overrides)
        n_fwd = stats[plan_tag]["batches"]
        kernels.reset_launch_counts()
        pred = predict(model, records, plans[plan_tag])
        counts = kernels.launch_counts()
        want = {k: (8 * n_fwd if k == kernel else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"onehot {name}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = close(f"onehot predict {name}", torch.from_numpy(pred),
                    torch.from_numpy(reference(plan_tag, ref)), *tol)
        serve[name] = {"max_abs_err": err, "launches": counts, "batches": n_fwd}
        log(f"[onehot] predict {name} over {len(records)} records in {n_fwd} {plan_tag} "
            f"batches: pred max|err| {err:.3e} vs plain {ref} on the same batches (rtol/atol "
            f"{tol[0]}), launches {counts}")
    # the layouts change the batching, not the function: plain gather f32 per
    # record on aligned batches against the sorted ones
    plain, _ = model_for("aligned f32", {})
    with deterministic():
        on_sorted = predict(plain, records, sorted_plan)
    layout_err = close("plain gather f32 aligned vs sorted", torch.from_numpy(refs[(
        "aligned f32", "gather f32")]), torch.from_numpy(on_sorted), F32_TOL, F32_TOL)
    log(f"[onehot] plain gather f32 on aligned batches against the sorted batches of the "
        f"same records: max|err| {layout_err:.3e} (rtol/atol {F32_TOL})")

    # training: 3 steps per arm on the first 3 batches of its plan
    tcfg = TrainConfig()
    dev_batches = {tag: [b.to(dev) for b in host[tag][:TRAIN_STEPS]] for tag in plans}
    arms, train = {}, {}
    for name, plan_tag, overrides, ref in ONEHOT_TRAIN:
        model, cfg = model_for(plan_tag, overrides)
        arms[name] = arm = train_arm(f"onehot {name}", model, cfg, tcfg, dev_batches[plan_tag])
        for k, v in arm["counts"].items():
            launches[k] = launches.get(k, 0) + v
        msg = f"[onehot] train {name}: losses {arm['losses']}, launches {arm['counts']}"
        if ref is not None:
            msg += hold_train_arm(f"onehot {name}", arm, arms[ref], ref, cfg.compute_dtype)
        train[name] = {"losses": arm["losses"], "launches": arm["counts"]}
        log(msg)
    remat_err = grads_close("onehot remat", arms["onehot f32 vloop, remat"]["grads"],
                            arms["onehot f32 vloop"]["grads"], REMAT_TOL)
    train["remat_vs_plain_max_grad_err"] = remat_err
    log(f"[onehot] remat's first gradients against the same arm without it: max |err| "
        f"{remat_err:.3e} of the tensor's max (bound {REMAT_TOL}·(|want| + max|want|))")

    # fit(): twice from the same weights under deterministic algorithms
    fit_plan = plan_capacities(fit_data["records"], FIT_BATCH, edge_layout=layout, window=w32)
    n_dev = sum(1 for _ in iter_batches(fit_data["dev"], fit_plan))
    fit_base = base.replace(message_impl="onehot", onehot_window=w32)
    fits = []
    with deterministic():
        for i in range(2):
            model = ViscosityModel(fit_base, seed=0)
            model.load_state_dict(state)
            res, summary = counted_fit(
                f"onehot f32 aligned, run {i + 1}", model, fit_base,
                # the host loader, which this check holds; [device_epochs]
                # drives the device-epoch path
                TrainConfig(epochs=ONEHOT_FIT_EPOCHS, batch_size=FIT_BATCH, seed=0,
                            device_epochs=False),
                fit_data["train"], fit_data["dev"], fit_plan, n_dev)
            fits.append((res, summary))
    (a, sa), (b, _) = fits
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        if a.history[key] != b.history[key]:
            raise AssertionError(f"onehot fit: two runs' {key} differ: {a.history[key]} vs "
                                 f"{b.history[key]}")
    if any(not torch.equal(v, b.params[k]) for k, v in a.params.items()):
        raise AssertionError("onehot fit: two runs' best weights differ")
    if not a.history["loss"][-1] < a.history["loss"][0]:
        raise AssertionError(f"onehot fit: the loss did not fall: {a.history['loss']}")
    log(f"[onehot] fit() twice, {ONEHOT_FIT_EPOCHS} epochs, deterministic: histories and "
        f"best weights equal bit for bit; loss {a.history['loss']}, val_loss "
        f"{a.history['val_loss']}; cation N={fit_plan.node_cap} tile {fit_plan.edge_tile}")
    fit_summary = {k: v for k, v in sa.items() if k != "history"}
    fit_summary.update(loss=a.history["loss"], val_loss=a.history["val_loss"])

    # times: wall and host first, with CUDA events (the profiler comes later)
    timed_models = {name: model_for(plan_tag, overrides)[0]
                    for name, plan_tag, overrides, *_ in ONEHOT_SERVE if name in ONEHOT_TIMED}
    timed_batch = {name: dev_batches[plan_tag][0]
                   for name, plan_tag, *_ in ONEHOT_SERVE if name in ONEHOT_TIMED}
    forward = {}
    with torch.inference_mode():
        for name, model in timed_models.items():
            batch = timed_batch[name]
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            forward[name] = forward_times(lambda: model(batch))
            forward[name].update(memory_peak_above_base_mb=(
                torch.cuda.max_memory_allocated() - base) / 2**20, memory_base_mb=base / 2**20)
    steps = {}
    for name in ONEHOT_TIMED:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plan_tag = next(p for n, p, *_ in ONEHOT_TRAIN if n == name)
        steps[name] = time_train_step(arms[name]["step"], host[plan_tag][0], iters=20, warmup=3)
        steps[name].update(memory_peak_above_base_mb=(
            torch.cuda.max_memory_allocated() - base) / 2**20, memory_base_mb=base / 2**20)
    for name in arms:
        arms[name]["grads"] = None
    seconds = time.perf_counter() - t_phase
    log(f"[onehot] checks and wall-clock timings in {seconds:.1f} s")

    def profile(sorted_forward):
        """Busy time, idle share and top kernels of the timed forwards and
        train steps (a profiler session each, as phase 13 takes them), and
        the fused kernels' device time per forward on aligned batches
        against ``sorted_forward``, phase 13's profile of the same
        configuration on sorted batches."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for name, model in timed_models.items():
                batch = timed_batch[name]
                prof = device_profile(lambda: model(batch), n=20)
                f = forward[name]
                f.update(busy_ms=prof["busy_ms"], device_ms=prof["device_ms"],
                         idle_share=max(0.0, 1 - prof["busy_ms"] / f["wall_ms"]),
                         fused_kernels_ms=sum(v for k, v in prof["by_kernel"].items()
                                              if "fused_message" in k),
                         top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
                log(f"[onehot] forward {name}: wall {f['wall_ms']:.4f} ms, host "
                    f"{f['host_ms']:.4f} ms, device busy {f['busy_ms']:.4f} ms, idle share "
                    f"{f['idle_share']:.3f}, peak memory {f['memory_peak_above_base_mb']:.1f} MiB "
                    f"above the {f['memory_base_mb']:.1f} MiB held before; top kernels ms: "
                    + json.dumps({k: round(v, 5) for k, v in f["top"].items()}))
        for name in ONEHOT_TIMED:
            step, batch = arms[name]["step"], timed_batch[name]
            prof = device_profile(lambda: step(batch), n=10)
            t = steps[name]
            t.update(busy_ms=prof["busy_ms"], device_ms=prof["device_ms"],
                     idle_share=max(0.0, 1 - prof["busy_ms"] / t["step_ms"]),
                     top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
            log(f"[onehot] train step {name}: {t['step_ms']:.4f} ms (median of {t['iters']}), "
                f"host {t['host_ms']:.4f} ms, {t['edges_per_s']:.6e} message-edges/s "
                f"({t['message_edges_per_step']} per step), device busy {t['busy_ms']:.4f} ms, "
                f"idle share {t['idle_share']:.3f}, peak memory "
                f"{t['memory_peak_above_base_mb']:.1f} MiB above the {t['memory_base_mb']:.1f} "
                f"MiB held before; top kernels ms: "
                + json.dumps({k: round(v, 5) for k, v in t["top"].items()}))
        on_layouts = {
            "sorted": sum(v for k, v in sorted_forward["top"].items() if "fused_message" in k),
            "window_aligned": forward["pallas_step bf16 aligned"]["fused_kernels_ms"]}
        log("[onehot] pallas_step bf16: the fused kernels' device time per forward on sorted "
            "and on window_aligned batches, ms: " + json.dumps(on_layouts))
        log(f"[onehot] profiler readings in {time.perf_counter() - t0:.1f} s")
        return {"forward": forward, "train_step": steps, "kernels_by_layout": on_layouts}

    results = {"plans": stats, "kernels_on_aligned": kernel_errs, "serve": serve,
               "aligned_vs_sorted_max_abs_err": layout_err, "train": train,
               "fit": fit_summary, "seconds": seconds}
    return results, launches, profile


# ---------------------------------------------------------------- phase 10b

DE_WINDOW = 64  # the bf16 onehot window (resolve_onehot_window)
DE_SMALL_BATCH = 256  # replay against eager: ~10 paired steps of the fit records per epoch
DE_FIT_EPOCHS = 3  # the first holds the captures; the steady epoch is the median of the rest
DE_INNER = 8  # the paired bench step: K = 8 steps per replay, as the bench's default


def _runner_state(step, losses, ns):
    """What a device epoch leaves: its losses and counts, the parameters,
    both Adam moments, the update count and the steps taken (host copies)."""
    params, mu, nu, count = optimizer_state(step)
    return {"losses": losses.cpu(), "ns": list(ns), "params": [p.cpu() for p in params],
            "mu": [m.cpu() for m in mu], "nu": [v.cpu() for v in nu], "count": count,
            "steps": step.steps}


def _same_runner_state(tag, a, b):
    if (a["ns"], a["count"], a["steps"]) != (b["ns"], b["count"], b["steps"]):
        raise AssertionError(f"{tag}: counts {a['ns']} / {b['ns']}, updates {a['count']} / "
                             f"{b['count']}, steps {a['steps']} / {b['steps']}")
    if not torch.equal(a["losses"], b["losses"]):
        raise AssertionError(f"{tag}: losses {a['losses'].tolist()} != {b['losses'].tolist()}")
    for key in ("params", "mu", "nu"):
        bad = [i for i, (x, y) in enumerate(zip(a[key], b[key])) if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"{tag}: {key} differ in tensors {bad[:5]}")


def phase_device_epochs(records, vocab, state, dev, fit_data):
    """Device-resident epochs (``training/device_epochs.py``) on the card:
    device-packed batches against the same function on the CPU, replayed
    epochs against eager ones and against one with an extra empty step (bit
    for bit), a paired onehot f32 step against plain gather on the
    host-packed same records, a resumed device-epoch fit() against an
    uninterrupted one; then the paired bench step and fit() epochs with and
    without device epochs. Returns the results, the kernel launches of the
    phase (onehot launches none) and the profiler's reading (called after
    every wall-clock timing of the script)."""
    import tempfile

    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.benchmarks.harness import _time_calls, paired_epoch_runner
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.data.packing import _batch_arrays
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import data_loss, fit, l2_penalty, make_train_step
    from ionic_mpnn_torch.training.device_epochs import (DeviceEpochs, _device_batch,
                                                         _device_batch_paired,
                                                         build_device_dataset,
                                                         build_paired_perm, choose_paired_plan)
    from ionic_mpnn_torch.training.graphs import Replay

    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    W = DE_WINDOW
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, onehot_window=W,
                            message_impl="onehot")

    def model_for(**kw):
        cfg = base.replace(**kw)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        return model, cfg

    out = {}
    # -- batches packed on the card against the same function on the CPU
    ds_c = build_device_dataset(records, W, "log_eta", device=dev)
    ds_h = build_device_dataset(records, W, "log_eta", device="cpu")
    pplan = choose_paired_plan(ds_h, BATCH)
    if pplan is None or choose_paired_plan(ds_c, BATCH) != pplan:
        raise AssertionError(f"[device_epochs] paired plans {pplan} / "
                             f"{choose_paired_plan(ds_c, BATCH)}")
    order = np.random.default_rng(0).permutation(ds_h.n).astype(np.int32)
    perm = build_paired_perm(ds_h, order, pplan)
    R = pplan.regions
    plain_idx = np.concatenate([order[:BATCH - 5], np.full(5, ds_h.n, np.int32)])
    cases = (("plain", plain_idx, _device_batch),
             ("paired", perm[:2 * R], lambda ds, i: _device_batch_paired(ds, i, pplan)))
    for name, idx, pack in cases:
        got = _batch_arrays(pack(ds_c, torch.from_numpy(idx).to(dev)))
        want = _batch_arrays(pack(ds_h, torch.from_numpy(idx)))
        if got.keys() != want.keys():
            raise AssertionError(f"[device_epochs] {name} batch fields {got.keys()}")
        for k in want:
            if not torch.equal(got[k].cpu(), want[k]):
                raise AssertionError(f"[device_epochs] {name} batch on the card differs from "
                                     f"the CPU's in {k}")
    log(f"[device_epochs] {len(records)} bench records, window {W}: {pplan}; the plain "
        f"({BATCH} slots, 5 sentinels) and paired ({2 * R} slots) batches packed on the card "
        f"equal the CPU's array for array, pads included")
    out["plan"] = {k: getattr(pplan, k) for k in ("region_c", "region_a", "regions",
                                                  "pair_frac", "edge_budget_c",
                                                  "edge_budget_a")}

    # -- a paired onehot f32 step against plain gather f32 on the same records
    idx0 = perm[:2 * R]
    host_recs = [records[i] for i in idx0 if i >= 0]
    hplan = plan_capacities(host_recs, len(host_recs))
    host_batches = list(iter_batches(host_recs, hplan))
    if len(host_batches) != 1:
        raise AssertionError(f"[device_epochs] {len(host_batches)} host batches")
    arms = {}
    for name, (model, cfg), batch in (
            ("paired onehot f32", model_for(), _device_batch_paired(
                ds_c, torch.from_numpy(idx0).to(dev), pplan)),
            ("gather f32 (plain)", model_for(message_impl="gather"),
             host_batches[0].to(dev))):
        loss = (data_loss(model(batch)["pred"], batch.y, batch.sample_mask, "mse", 1.0)
                + l2_penalty(model, cfg.fp_l2))
        loss.backward()
        grads = {param_name(k): p.grad.detach().clone() for k, p in model.named_parameters()}
        del loss
        step = make_train_step(model, cfg, TrainConfig())
        if name.startswith("paired"):
            runner = DeviceEpochs(step, ds_c, BATCH, plan=pplan)
            losses, _ = runner.run(idx0)
        else:
            losses = step(batch)["loss"].reshape(1)
        arms[name] = {"grads": grads, "losses": [float(losses[0])]}
    g_err = grads_close("[device_epochs] paired onehot f32 step", arms["paired onehot f32"][
        "grads"], arms["gather f32 (plain)"]["grads"], TRAIN_TOL["float32"][0])
    a, b = arms["paired onehot f32"]["losses"][0], arms["gather f32 (plain)"]["losses"][0]
    if abs(a - b) > TRAIN_TOL["float32"][1][0] * abs(b):
        raise AssertionError(f"[device_epochs] paired step loss {a!r} vs plain {b!r}")
    out["paired_vs_plain"] = {"max_grad_err": g_err, "loss": a, "plain_loss": b}
    log(f"[device_epochs] one paired onehot f32 step ({len(host_recs)} records) against plain "
        f"gather f32 on the host-packed same records: max gradient |err| {g_err:.3e} of the "
        f"tensor's max, loss {a!r} vs {b!r}")

    # -- replayed epochs against eager, and against an extra empty step
    train, dev_split = fit_data["train"], fit_data["dev"]
    ds_t = build_device_dataset(train, W, "log_eta", device=dev)
    plan_t = choose_paired_plan(ds_t, DE_SMALL_BATCH)
    out["replay"] = {}
    with deterministic():
        for dtype in ("float32", "bfloat16"):
            runs = {}
            for tag, graphed, empty in (("eager", False, 0), ("graphed", True, 0),
                                        ("graphed + empty step", True, 1)):
                model, cfg = model_for(compute_dtype=dtype)
                step = make_train_step(model, cfg, TrainConfig(), jit_compile=graphed)
                runner = DeviceEpochs(step, ds_t, DE_SMALL_BATCH, plan=plan_t)
                p = runner.epoch_perm(1)
                p = np.concatenate([p, np.full(empty * runner.B, -1, np.int32)])
                losses, ns = runner.run(p)
                runs[tag] = _runner_state(step, losses, ns)
            n = len(runs["eager"]["ns"])
            if n <= runner.K or n % runner.K == 0:
                raise AssertionError(f"[device_epochs] {n} steps: no group and remainder")
            for tag in ("graphed", "graphed + empty step"):
                _same_runner_state(f"[device_epochs] {dtype} {tag} vs eager", runs[tag],
                                   runs["eager"])
            out["replay"][dtype] = {"steps": n, "K": runner.K,
                                    "losses": runs["eager"]["losses"].tolist()}
            log(f"[device_epochs] {dtype}: a paired epoch of {n} steps at batch "
                f"{DE_SMALL_BATCH} (K = {runner.K}: groups and a remainder) replayed equals the "
                f"eager steps, and with an extra empty step the same, bit for bit: losses, "
                f"parameters, both moments, {runs['eager']['count']} updates")

    # -- fit(): resumed against uninterrupted (deterministic), then timed
    fplan = plan_capacities(fit_data["records"], FIT_BATCH, edge_layout="window_aligned",
                            window=W)

    def device_fit(epochs, **kw):
        model, cfg = model_for(compute_dtype="bfloat16")
        tcfg = TrainConfig(epochs=epochs, batch_size=FIT_BATCH, seed=0, **kw)
        return fit(model, cfg, tcfg, train, dev_split, fplan, verbose=False)

    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        whole = device_fit(DE_FIT_EPOCHS)
        device_fit(DE_FIT_EPOCHS - 1, checkpoint_dir=tmp, checkpoint_every=1)
        resumed = device_fit(DE_FIT_EPOCHS, checkpoint_dir=tmp)
    if whole.loader != "device_paired" or resumed.loader != "device_paired":
        raise AssertionError(f"[device_epochs] fit loaders {whole.loader} / {resumed.loader}")
    same_fit("[device_epochs] resumed device-epoch fit against uninterrupted", whole, resumed)
    log(f"[device_epochs] fit() onehot bf16 paired, {DE_FIT_EPOCHS} epochs, resumed at epoch "
        f"{DE_FIT_EPOCHS - 1} equals uninterrupted bit for bit; loss {whole.history['loss']}")

    fits = {}
    for tag, kw, loader in (("device paired", {}, "device_paired"),
                            ("device unpaired", {"paired_epochs": False}, "device"),
                            ("native loader", {"device_epochs": False}, "native")):
        res = device_fit(DE_FIT_EPOCHS, **kw)
        if res.loader != loader:
            raise AssertionError(f"[device_epochs] fit {tag}: loader {res.loader}")
        if not all(np.isfinite(res.history["loss"])):
            raise AssertionError(f"[device_epochs] fit {tag}: loss {res.history['loss']}")
        fits[tag] = epoch_summary(res)
        fits[tag].update(loss=res.history["loss"], train_steps=res.steps)
        log(f"[device_epochs] fit() onehot bf16 w{W} batch {FIT_BATCH}, {tag}: steady epoch "
            f"{fits[tag]['epoch_s']:.4f} s (first {fits[tag]['first_epoch_s']:.4f} s), "
            f"{fits[tag]['train_steps_per_s']:.1f} train steps/s, {res.steps} steps, dispatch "
            f"{fits[tag]['dispatch_s']:.4f} s per epoch, loss {res.history['loss']}")
    out["fit"] = fits

    # -- the paired bench step at batch 2048, onehot bf16
    brecs, bvocab = make_bench_dataset(DE_INNER * BATCH)
    hb = plan_capacities(brecs, BATCH, edge_layout="window_aligned", window=W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    setup = paired_epoch_runner(brecs, bvocab, BATCH, 4, "bfloat16", DE_INNER, W, device=dev)
    if setup is None:
        raise AssertionError("[device_epochs] no paired plan for the bench records")
    runner, bplan = setup["runner"], setup["plan"]

    def call():
        runner.g0.zero_()
        return runner.steps(DE_INNER)

    t = _time_calls(call, dev, DE_INNER, setup["message_edges_per_step"],
                    setup["records_per_step"], iters=20, warmup=3, sync_each=False)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**20

    def packs():
        return [x for k in range(DE_INNER) for x in _batch_arrays(runner.batch(k)).values()]

    pack_graph = Replay(packs, dev, graphed=True)
    runner.g0.zero_()
    pack_ms = time_ms(pack_graph, n=50) / DE_INNER
    windows = {"cation": bplan.regions * bplan.region_c // W,
               "anion": bplan.regions * bplan.region_a // W,
               "host_cation": hb.node_cap // W, "host_anion": hb.anion_node_cap // W}
    bench = {"step_ms": t["step_ms"], "call_ms": t["call_ms"], "host_ms": t["host_ms"],
             "edges_per_s": t["edges_per_s"], "wall_s": t["wall_s"],
             "message_edges_per_step": setup["message_edges_per_step"],
             "records_per_step": setup["records_per_step"], "pack_ms": pack_ms,
             "windows": windows, "memory_peak_above_base_mb": peak,
             "plan": {k: getattr(bplan, k) for k in ("region_c", "region_a", "regions",
                                                      "pair_frac", "edge_budget_c",
                                                      "edge_budget_a")},
             "loss": t["loss"]}
    out["bench_step"] = bench
    log(f"[device_epochs] paired bench step, batch {BATCH}, onehot bf16 w{W}, K = {DE_INNER}: "
        f"{t['step_ms']:.4f} ms per step (call {t['call_ms']:.4f} ms; host {t['host_ms']:.4f} ms "
        f"per step), {t['edges_per_s']:.6e} message-edges/s "
        f"({setup['message_edges_per_step']} per step, "
        f"{setup['records_per_step']:.1f} records), pack alone {pack_ms:.4f} ms per step; "
        f"cation windows {windows['cation']} (host plan {windows['host_cation']}), anion "
        f"{windows['anion']} (host plan {windows['host_anion']}); peak "
        f"{peak:.1f} MiB above the {mem0 / 2**20:.1f} MiB held before")
    after = kernels.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    if any(launches.values()):
        raise AssertionError(f"[device_epochs] onehot launched CUDA kernels: {launches}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[device_epochs] checks and wall-clock timings in {out['seconds']:.1f} s")

    def profile():
        prof = device_profile(call, n=5)
        res = {"busy_ms": prof["busy_ms"], "call_ms": t["call_ms"],
               "busy_share": min(1.0, prof["busy_ms"] / t["call_ms"]),
               "top": {k_[:60]: v for k_, v in list(prof["by_kernel"].items())[:6]}}
        log(f"[device_epochs] profiler: busy {prof['busy_ms']:.4f} ms per replay of "
            f"{DE_INNER} paired steps against a {t['call_ms']:.4f} ms call, busy share "
            f"{res['busy_share']:.3f}; top kernels ms: "
            + json.dumps({k_: round(v, 5) for k_, v in res["top"].items()}))
        return res

    return out, launches, profile


# ---------------------------------------------------------------- phase 11

# Launches of one transfer-model train step (4 message steps, pallas_step),
# reckoned from the code: the forward runs 8 fused_mp_step whatever is
# frozen. Stage 1 freezes the trunk, so no message step records a gradient
# and none goes through the FusedMPStep Function: no backward launch. Stage
# 2 unfreezes steps 2-3 of each ion: step 2's input state is frozen, so
# its backward runs the remat alone; step 3's also needs dh. Per ion 3
# fused_message_aggregate of which 1 dh, and 2 dK (both steps' tables train).
TRANSFER_LAUNCHES = {
    1: {"sorted_segment_sum": 0, "fused_message_aggregate": 0, "fused_mp_step": 8,
        "fused_message_aggregate_dh": 0, "fused_message_table_grad": 0},
    2: {"sorted_segment_sum": 0, "fused_message_aggregate": 6, "fused_mp_step": 8,
        "fused_message_aggregate_dh": 2, "fused_message_table_grad": 4},
}
BN_TOL = 1e-4  # the BatchNorm running statistics against plain's


def phase_transfer(records, vocab, state):
    """The transfer model at full width (the viscosity trunk of [main]'s
    weights, head 256/128/64, dropout 0) on the bench batches planned
    without temperature, with a teacher's melting points: the pallas_step
    f32 forward against plain gather f32 in eval mode, then one stage-1 and
    one stage-2 train step (Huber, partitioned Adam) on both from the same
    weights: losses and gradients within TRAIN_TOL, frozen tensors bit
    for bit unchanged, BatchNorm statistics at BN_TOL, launch counts exact."""
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import (TransferMPModel, load_trunk_params,
                                         transfer_stage_labels)
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import make_partitioned_optimizer, make_train_step, predict

    t_phase = time.perf_counter()
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                            transfer_dropout=0.0).replace(head="transfer")
    plan = plan_capacities([dict(r, mp=0.0) for r in records], BATCH, headroom=2.0,
                           with_temperature=False, target_key="mp")
    teacher = TransferMPModel(base, seed=1)
    load_trunk_params(teacher, state)
    records = teacher_records([dict(r, mp=0.0) for r in records], plan, teacher, "mp")
    batches = list(iter_batches(records, plan))
    if len(batches) != N_BATCHES:
        raise AssertionError(f"transfer: {len(batches)} batches, expected {N_BATCHES}")

    def model_for(impl):
        cfg = base.replace(message_impl=impl)
        model = TransferMPModel(cfg, seed=0)
        load_trunk_params(model, state)
        return model, cfg

    plain, plain_cfg = model_for("gather")
    kernel, kernel_cfg = model_for("pallas_step")
    kernel.load_state_dict(plain.state_dict())
    want = predict(plain, records, plan)
    kernels.reset_launch_counts()
    got = predict(kernel, records, plan)
    counts = kernels.launch_counts()
    expect = {k: N_BATCHES * TRANSFER_LAUNCHES[1].get(k, 0) if k == "fused_mp_step" else 0
              for k in counts}
    if counts != expect:
        raise AssertionError(f"transfer predict: launch counts {counts}, expected {expect}")
    launches = dict(counts)
    err = close("transfer predict pallas_step f32", torch.from_numpy(got),
                torch.from_numpy(want), *MODEL_TOL)
    log(f"[transfer] predict over {len(records)} records in {N_BATCHES} batches (eval "
        f"mode): fused_mp_step launched {counts['fused_mp_step']} times, pred max|err| "
        f"{err:.3e} vs plain gather f32 (rtol/atol {MODEL_TOL[0]})")

    tcfg = TrainConfig(loss="huber", huber_delta=1.0)
    grad_tol, loss_tols = TRAIN_TOL["float32"]
    out = {"predict_max_abs_err": err, "steps": {}}
    for stage, batch in ((1, batches[0]), (2, batches[1])):
        results = {}
        # both arms from the same weights: stage 1's Adam step moves each
        # arm's near-zero gradient entries by up to the learning rate, in
        # either direction, so stage 2 would otherwise start from weights
        # that differ by more than its tolerance
        kernel.load_state_dict(plain.state_dict())
        for name, model, cfg in (("plain", plain, plain_cfg), ("kernel", kernel, kernel_cfg)):
            labels = transfer_stage_labels(model, stage)
            opt = make_partitioned_optimizer(model, labels, 1e-3 if stage == 1 else 1e-4)
            step = make_train_step(model, cfg, tcfg, opt)
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            kernels.reset_launch_counts()
            with deterministic():  # the readout's sums in one order, run after run
                loss = float(step(batch)["loss"])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            frozen = [k for k, v in labels.items() if v == "frozen"]
            params = dict(model.named_parameters())
            moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
            if moved:
                raise AssertionError(f"transfer stage {stage} {name}: frozen tensors moved: "
                                     f"{moved[:5]}")
            grads = {k: p.grad.detach().clone() for k, p in params.items()
                     if labels[k] == "trainable"}
            if not all(torch.isfinite(g).all() for g in grads.values()) or not np.isfinite(loss):
                raise AssertionError(f"transfer stage {stage} {name}: non-finite step")
            results[name] = {"loss": loss, "counts": counts, "grads": grads,
                             "stats": {k: v.clone() for k, v in model.named_buffers()},
                             "trainable": len(grads), "frozen": len(frozen)}
        want_counts = {k: TRANSFER_LAUNCHES[stage].get(k, 0) for k in results["kernel"]["counts"]}
        if results["kernel"]["counts"] != want_counts:
            raise AssertionError(f"transfer stage {stage}: launch counts "
                                 f"{results['kernel']['counts']}, expected {want_counts}")
        if any(results["plain"]["counts"].values()):
            raise AssertionError(f"transfer stage {stage}: plain launched kernels")
        for k, v in results["kernel"]["counts"].items():
            launches[k] += v
        a, b = results["kernel"]["loss"], results["plain"]["loss"]
        if abs(a - b) > loss_tols[stage - 1] * abs(b):
            raise AssertionError(f"transfer stage {stage}: loss {a!r} vs plain {b!r}")
        g_err = grads_close(f"transfer stage {stage}", results["kernel"]["grads"],
                            results["plain"]["grads"], grad_tol)
        bn_err = max(close(f"transfer stage {stage} {k}", v, results["plain"]["stats"][k],
                           BN_TOL, BN_TOL)
                     for k, v in results["kernel"]["stats"].items())
        out["steps"][f"stage {stage}"] = {
            "loss": a, "plain_loss": b, "grad_err": g_err, "bn_err": bn_err,
            "launches": results["kernel"]["counts"],
            "trainable_tensors": results["kernel"]["trainable"],
            "frozen_tensors": results["kernel"]["frozen"]}
        log(f"[transfer] stage {stage} train step: loss {a!r} (plain {b!r}), "
            f"{results['kernel']['trainable']} trainable / {results['kernel']['frozen']} "
            f"frozen tensors, frozen bit-identical, max gradient |err| {g_err:.3e} of the "
            f"tensor's max, BatchNorm statistics max|err| {bn_err:.3e}, launches "
            f"{results['kernel']['counts']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[transfer] phase {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------- phase 12

CHAIN_EPOCHS = 2
CHAIN_TIMEOUT = 600
# runs the module named by its first argument as `python -m` would, after
# making every import of JAX, its libraries and the JAX package fail
CHAIN_NO_JAX = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ionic_mpnn_tpu'):\n"
    "    sys.modules[name] = None\n"
    "module = sys.argv.pop(1)\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n")


def chain_metrics(text):
    """``{split: (r2, mae)}`` from a CLI's ``Split: R2=x, MAE=y`` lines."""
    out = {}
    for m in re.finditer(r"^\s*(Train|Dev|Test): R2=(\S+), MAE=(\S+)", text, re.M):
        out[m.group(1)] = (float(m.group(2).rstrip(",")), float(m.group(3)))
    return out


def phase_chain():
    """The reproduction chain as users run it, each CLI a process of its own
    (``python -m ionic_mpnn_torch.cli.*``, with every import of JAX made to
    fail, whether or not the machine has it): prepare_data
    --synthetic at the reference scale; train_viscosity beside
    train_melting_point; train_transfer on train_viscosity's checkpoint
    beside screen on that checkpoint in candidate mode and with
    --grid-cations (the brute-force device sweep); then evaluate. Each must
    exit 0, write its files, report launches of the CUDA kernels, and
    evaluate's metrics must repeat each training CLI's."""
    import importlib.util
    import tempfile

    t_phase = time.perf_counter()
    log(f"[chain] jax installed here: {importlib.util.find_spec('jax') is not None}; "
        f"every CLI process below blocks its import")
    out = {"steps": {}}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data, res = Path(tmp) / "data", Path(tmp) / "results"
        vocab = ["--vocab", str(data / "vocab.pkl")]
        epochs = ["--epochs", str(CHAIN_EPOCHS)]
        screen = [*vocab, "--checkpoint", str(res / "viscosity" / "checkpoints")]
        steps = [
            ("prepare_data", ["--data-dir", str(data), "--synthetic"],
             [data / f for f in ("CA.smi", "VISCOSITY.txt", "MP.txt", "vocab.pkl",
                                 "viscosity_graph_data.pkl", "mp_graph_data.pkl",
                                 "viscosity_id_data.pkl", "mp_id_data.pkl",
                                 "viscosity_id_data.npz", "mp_id_data.npz")]),
            ("train_viscosity", ["--data", str(data / "viscosity_id_data.pkl"), *vocab,
                                 "--out-dir", str(res / "viscosity"), *epochs],
             [res / "viscosity" / "history_viscosity.pkl", res / "viscosity" / "checkpoints"]),
            ("train_melting_point", ["--data", str(data / "mp_id_data.pkl"), *vocab,
                                     "--out-dir", str(res / "melting_point"), *epochs],
             [res / "melting_point" / f for f in ("history_mp.pkl", "checkpoints",
                                                  "mp_norm_params.json")]),
            ("train_transfer", ["--data", str(data / "mp_id_data.pkl"), *vocab,
                                "--viscosity-checkpoint",
                                str(res / "viscosity" / "checkpoints"),
                                "--out-dir", str(res / "transfer"), *epochs],
             [res / "transfer" / f for f in ("history_transfer.pkl", "checkpoints",
                                             "scaler.json")]),
            # screening on train_viscosity's checkpoint: the template pairs, then
            # the enumerated cations x the screening anions through the device sweep
            ("screen", [*screen, "--out", str(res / "screen" / "candidates.csv")],
             [res / "screen" / "candidates.csv"]),
            ("screen --grid-cations", [*screen, "--grid-cations", str(SCREEN_CATIONS),
                                       "--temperatures", "298.15,323.15", "--brute-force",
                                       "--out", str(res / "screen" / "grid.csv")],
             [res / "screen" / "grid.csv"]),
            ("evaluate", ["--data-dir", str(data), "--results-dir", str(res),
                          "--out-dir", str(res / "eval")], [res / "eval" / "metrics.json"]),
        ]
        # waves of CLIs that need only what earlier waves wrote, the CLIs of
        # a wave side by side: the data; the two trainings from scratch; the
        # transfer and the screens on train_viscosity's checkpoint; evaluate
        waves = [["prepare_data"], ["train_viscosity", "train_melting_point"],
                 ["train_transfer", "screen", "screen --grid-cations"], ["evaluate"]]
        by_name = {name: (args, files) for name, args, files in steps}
        if sorted(by_name) != sorted(n for wave in waves for n in wave):
            raise AssertionError(f"chain: the waves {waves} do not hold {sorted(by_name)}")

        def cli(name):  # python -m, with JAX and the JAX package unimportable
            module = f"ionic_mpnn_torch.cli.{name.split()[0]}"
            cmd = [sys.executable, "-c", CHAIN_NO_JAX, module, *by_name[name][0]]
            return subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                                  timeout=CHAIN_TIMEOUT)

        for wave in waves:
            ran = run_together({name: (lambda n=name: cli(n)) for name in wave})
            for name in wave:
                files = by_name[name][1]
                proc, seconds = ran[name]
                if proc.returncode != 0:
                    raise AssertionError(f"chain: {name} exited {proc.returncode}:\n"
                                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
                missing = [str(f) for f in files if not f.exists()]
                if missing:
                    raise AssertionError(f"chain: {name} did not write {missing}")
                step = {"seconds": seconds}
                m = re.search(r"^kernel launches (\{.*\})$", proc.stdout, re.M)
                if name != "prepare_data":
                    if m is None:
                        raise AssertionError(f"chain: {name} printed no launch counts")
                    step["launches"] = json.loads(m.group(1))
                    if not step["launches"]["fused_mp_step"] > 0:
                        raise AssertionError(f"chain: {name} ran no CUDA kernel: "
                                             f"{step['launches']}")
                    for k, v in step["launches"].items():
                        launches[k] = launches.get(k, 0) + v
                if name.startswith("train_"):
                    step["metrics"] = chain_metrics(proc.stdout)
                    if set(step["metrics"]) != {"Train", "Dev", "Test"} or not all(
                            np.isfinite(v).all() for v in step["metrics"].values()):
                        raise AssertionError(f"chain: {name} printed {step['metrics']}")
                if name == "train_transfer":
                    step["stages"] = [line for line in proc.stdout.splitlines()
                                      if re.match(r"stage \d: ", line)]
                    if len(step["stages"]) != 2:
                        raise AssertionError(f"chain: train_transfer stages {step['stages']}")
                    if not step["launches"]["fused_message_aggregate_dh"] > 0:
                        raise AssertionError("chain: stage 2 ran no dh launch")
                if name == "evaluate":
                    got = json.loads((res / "eval" / "metrics.json").read_text())
                    for task, trainer in (("viscosity", "train_viscosity"),
                                          ("melting_point", "train_melting_point"),
                                          ("transfer", "train_transfer")):
                        for split, (r2, mae_) in out["steps"][trainer]["metrics"].items():
                            g = got[task][split]
                            # the CLIs print 4 (R2) and 2 or 4 (MAE) decimals; the
                            # readout's atomics may move the last one
                            if (abs(g["r2"] - r2) > 1e-3 * (1 + abs(r2))
                                    or abs(g["mae"] - mae_) > 1e-2 + 1e-3 * abs(mae_)):
                                raise AssertionError(f"chain: evaluate {task} {split} {g} vs "
                                                     f"{trainer}'s R2={r2} MAE={mae_}")
                    step["metrics"] = got
                out["steps"][name] = step
                lines = [line.strip() for line in proc.stdout.splitlines()
                         if "R2=" in line or line.startswith(("stage ", "parsed ", "==", "split",
                                                              "Epoch ", "===", "grid sweep",
                                                              "screened in", "T grid"))]
                log(f"[chain] {name}: exit 0 in {seconds:.2f} s; launches "
                    f"{step.get('launches')}")
                for line in lines:
                    log(f"[chain]   {line}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[chain] phase {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------- [screen]

SCREEN_BATCH = 2048
SCREEN_K = 8  # batches per replay of the device sweep's graph
SCREEN_TOP_K = 100
SCREEN_CATIONS = 2688  # every cation enumerate_cations yields
SCREEN_TARGET = 10_000_000  # the CLI's --target-candidates rule sizes the T grid
SUB_GRID = (700, 3)  # cations and temperatures of the ~50k sub-grid (x 24 anions)
SHORT_GRID = (256, 1)  # the short sweeps in the other kernel configurations
HOST_GRID_T = 3  # the host path's grid: 2688 x 24 x 3 = 193,536 candidates
UNPARSED_ANION = "[O-]Cl(=O)(=O)=O"  # perchlorate: the built-in parser refuses it


def screen_library(n_cations=SCREEN_CATIONS):
    """The screening library (the first ``n_cations`` enumerated cations,
    every one by default, and the 25 screening anions) and a vocab built
    from it, so that no parsed ion is out of vocabulary; only perchlorate
    fails the built-in parser."""
    from ionic_mpnn_torch.data import build_vocab, smiles_to_graph
    from ionic_mpnn_torch.data.synthetic import SCREEN_ANIONS, enumerate_cations

    cations = enumerate_cations(n_cations)
    if len(cations) != n_cations:
        raise AssertionError(f"enumerate_cations gave {len(cations)} cations")
    graphs, failed = {}, []
    for s in cations + SCREEN_ANIONS:
        try:
            graphs[s] = smiles_to_graph(s)
        except ValueError:
            failed.append(s)
    if failed != [UNPARSED_ANION]:
        raise AssertionError(f"ions the parser refused: {failed}")
    c0, a0 = graphs[cations[0]], graphs[SCREEN_ANIONS[0]]
    records = ([{"cation_graph": graphs[c], "anion_graph": a0} for c in cations]
               + [{"cation_graph": c0, "anion_graph": graphs[a]}
                  for a in SCREEN_ANIONS if a in graphs])
    return cations, list(SCREEN_ANIONS), build_vocab([records])


def hold_top(tag, got, want, want_engine, tol):
    """Hold sweep ``got`` to sweep ``want`` (lowest predictions first): every
    candidate ``got`` returns agrees at ``tol`` with ``want``'s prediction
    of it (``want_engine`` predicts those ``want`` did not return), and a
    candidate only one of them returns lies within ``tol`` of ``want``'s
    k-th score. Returns (max |err|, candidates not shared)."""
    key = lambda r: (r.cation, r.anion, r.temperature)
    wp = {key(r): r.prediction for r in want}
    gp = {key(r): r.prediction for r in got}
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} results against {len(want)}")
    common = [k for k in gp if k in wp]
    err = close(tag, torch.tensor([gp[k] for k in common]),
                torch.tensor([wp[k] for k in common]), *tol)
    only_got = [k for k in gp if k not in wp]
    only_want = [k for k in wp if k not in gp]
    kth = want[-1].prediction
    near = lambda v: abs(v - kth) <= tol[1] + tol[0] * abs(kth)
    if only_got:
        plain = want_engine.predict_batch(only_got)
        err = max(err, close(f"{tag}, candidates only it returns",
                             torch.tensor([gp[k] for k in only_got]),
                             torch.from_numpy(np.asarray(plain, np.float32)), *tol))
        bad = [(k, float(p)) for k, p in zip(only_got, plain) if not near(float(p))]
        bad += [(k, wp[k]) for k in only_want if not near(wp[k])]
        if bad:
            raise AssertionError(f"{tag}: top-k sets differ beyond ties at the k-th score "
                                 f"{kth}: {bad[:4]}")
    return err, len(only_got)


def sweep_launches(impl, scatter, batches):
    """Exact kernel launches of ``batches`` 4-step forwards of both ions."""
    per_fwd = kernel_launches(impl, scatter)[1]
    return {k: batches * per_fwd.get(k, 0) for k in
            ("sorted_segment_sum", "fused_message_aggregate", "fused_mp_step",
             "fused_message_aggregate_dh", "fused_message_table_grad")}


def phase_screen(dev):
    """Screening at the viscosity model's published width with seeded
    random weights (``ionic_mpnn_torch/inference.py``): the device-packed
    batch against the host-packed one, the sweeps against each other and
    against plain on a ~50k sub-grid, the short sweeps in the other kernel
    configurations, then the BASELINE config-5 sweep of 10,063,872
    candidates, the host path, and the factorized sweep over the same grid.
    Returns the phase's record, its kernel launches, and a closure that
    reads the card's busy share over a few replays (run last: profiler)."""
    from ionic_mpnn_torch.config import resolve_compute_dtype, viscosity_config
    from ionic_mpnn_torch.data import BatchPlan, IonPairBatch
    from ionic_mpnn_torch.inference import IonPool, ScreeningEngine
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.ops import grid_pack
    from ionic_mpnn_torch.training.graphs import Replay

    t_phase = time.perf_counter()
    cations, anions, vocab = screen_library()
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    state = ViscosityModel(base, seed=0).state_dict()  # the port's seeded init
    B, K, k = SCREEN_BATCH, SCREEN_K, SCREEN_TOP_K
    plan = BatchPlan(B, B * 128, B * 256)  # the CLI's caps, for predict_batch

    def engine(impl="pallas_step", dtype=None, scatter="xla"):
        dtype = dtype or resolve_compute_dtype("auto", dev)
        cfg = base.replace(message_impl=impl, compute_dtype=dtype, scatter_impl=scatter)
        return ScreeningEngine(ViscosityModel(cfg, seed=0), state, vocab, plan)

    default = engine()  # pallas_step in the card's default compute dtype
    dtype = default.model.cfg.compute_dtype
    tol = BF16_MODEL_TOL if dtype == "bfloat16" else MODEL_TOL
    out = {"compute_dtype": dtype, "batch": B, "steps_per_call": K, "top_k": k}
    launches = {}

    def counted(tag, impl, scatter, n_batches, fn):
        kernels.reset_launch_counts()
        res = fn()
        counts = kernels.launch_counts()
        want = sweep_launches(impl, scatter, n_batches)
        if counts != want:
            raise AssertionError(f"{tag}: launch counts {counts}, expected {want}")
        for key_, v in counts.items():
            launches[key_] = launches.get(key_, 0) + v
        return res, counts

    def dispatched(total):  # batches a device sweep runs: K per replay
        return K * -(-total // (B * K))

    # 1. a device-packed batch against the same candidates packed on the host
    sub_c, sub_t = SUB_GRID
    sub_cations = cations[:sub_c]
    sub_temps = np.linspace(273.15, 393.15, sub_t).astype(np.float32)
    cat_pool, an_pool = IonPool(sub_cations, vocab), IonPool(anions, vocab)
    if [s for s, _ in an_pool.skipped] != [UNPARSED_ANION]:
        raise AssertionError(f"IonPool skipped {an_pool.skipped}")
    C, A = len(cat_pool), len(an_pool)
    total = C * A * sub_t
    splan = default._grid_plan(cat_pool, an_pool, sub_t, True, True)
    gids = np.arange(B)
    ci, ai, ti = gids % C, (gids // C) % A, gids // (C * A)
    host = IonPairBatch(
        cation=default._pack_side_cols(cat_pool.gather(ci), splan),
        anion=default._pack_side_cols(an_pool.gather(ai), splan, side="anion"),
        temperature=sub_temps[ti][:, None], y=np.zeros(B, np.float32),
        sample_mask=np.ones(B, np.float32)).to(dev)
    pools = [grid_pack.device_pool(p, device=dev) for p in (cat_pool, an_pool)]
    devb = grid_pack.grid_batch_on_device(
        *pools, torch.from_numpy(sub_temps).to(dev), 0, n_cations=C, n_anions=A, total=total,
        batch_size=B, node_cap=splan.node_cap, edge_cap=splan.edge_cap,
        anion_node_cap=splan.anion_node_cap, anion_edge_cap=splan.anion_edge_cap)
    for side in ("cation", "anion"):
        d, h = getattr(devb, side), getattr(host, side)
        if not torch.equal(d.node_mask, h.node_mask):
            raise AssertionError(f"device pack {side}: node masks differ")
        nm, dm, hm = d.node_mask, d.edge_mask, h.edge_mask
        for f in ("atom_ids", "node_graph", "node_local"):
            if not torch.equal(getattr(d, f)[nm], getattr(h, f)[nm]):
                raise AssertionError(f"device pack {side}: real {f} differ")
        for f in ("src", "dst", "bond_ids"):
            if not torch.equal(getattr(d, f)[dm], getattr(h, f)[hm]):
                raise AssertionError(f"device pack {side}: real-edge {f} differ")
    for f in ("temperature", "sample_mask"):
        if not torch.equal(getattr(devb, f), getattr(host, f)):
            raise AssertionError(f"device pack: {f} differs")
    f32 = engine(dtype="float32")
    errs = {}
    with torch.inference_mode():
        for name, e, t_ in ((dtype, default, tol), ("float32", f32, MODEL_TOL)):
            errs[name] = close(f"device-packed batch, pallas_step {name}",
                               e.model(devb)["pred"], e.model(host)["pred"], *t_)
    out["pack_vs_host"] = {"cation_N": devb.cation.node_capacity,
                           "cation_E": devb.cation.edge_capacity,
                           "anion_N": devb.anion.node_capacity,
                           "anion_E": devb.anion.edge_capacity,
                           "real_edges": int(devb.cation.edge_mask.sum()
                                             + devb.anion.edge_mask.sum()),
                           "max_abs_err": errs}
    log(f"[screen] library: {len(cations)} cations, {len(anions)} anions ({UNPARSED_ANION} "
        f"skipped: the built-in parser refuses it), vocab atoms {vocab.atom_vocab_size} "
        f"bonds {vocab.bond_vocab_size}; largest cation {int(cat_pool.a_len.max())} atoms "
        f"in the sub-grid")
    log(f"[screen] device-packed batch of {B} = the native packer's on real nodes and "
        f"edges (cation N={devb.cation.node_capacity} E={devb.cation.edge_capacity}, anion "
        f"N={devb.anion.node_capacity} E={devb.anion.edge_capacity}); forwards max|err| "
        + json.dumps(errs))
    del devb, host, pools

    # 2. the ~50k sub-grid, top 100
    grid = (sub_cations, anions, sub_temps)
    sweeps = {}
    sweeps["device"], _ = counted("sub-grid device", "pallas_step", "xla", dispatched(total),
                                  lambda: default.screen_grid(*grid, top_k=k, steps_per_call=K))
    sweeps["host"], _ = counted("sub-grid host", "pallas_step", "xla", -(-total // B),
                                lambda: default.screen_grid(*grid, top_k=k, device_pack=False))
    # the same kernels on batches packed two ways: only the readout's atomic
    # sums (index_add_) differ, so pairs may swap only at f32 noise
    err_dh, n_dh = hold_top("sub-grid device vs host sweep", sweeps["device"].results,
                            sweeps["host"].results, default, MODEL_TOL)
    sweeps["f32"], _ = counted("sub-grid pallas_step f32", "pallas_step", "xla",
                               dispatched(total),
                               lambda: f32.screen_grid(*grid, top_k=k, steps_per_call=K))
    plain = engine("gather", "float32")
    sweeps["plain"], _ = counted("sub-grid plain gather f32", "gather", "xla",
                                 dispatched(total),
                                 lambda: plain.screen_grid(*grid, top_k=k, steps_per_call=K))
    err_plain, n_tied = hold_top("sub-grid pallas_step f32 vs plain gather f32",
                                 sweeps["f32"].results, sweeps["plain"].results, plain,
                                 MODEL_TOL)
    sweeps["factorized"] = f32.screen_grid_factorized(*grid, top_k=k)
    err_fact, n_fact = hold_top("sub-grid factorized vs brute force", sweeps["factorized"].results,
                                sweeps["f32"].results, f32, MODEL_TOL)
    # the factorized sweep encodes the pools with the gather formulation (as
    # JAX's does); in the default dtype it is exact against a brute-force
    # sweep of that formulation, whose roundings pallas_step's do not share
    gather_default = engine("gather", dtype)
    sweeps["gather brute"], _ = counted(
        f"sub-grid gather {dtype}", "gather", "xla", dispatched(total),
        lambda: gather_default.screen_grid(*grid, top_k=k, steps_per_call=K))
    sweeps["factorized default"] = default.screen_grid_factorized(*grid, top_k=k)
    err_fd, n_fd = hold_top(f"sub-grid factorized {dtype} vs gather {dtype} brute force",
                            sweeps["factorized default"].results,
                            sweeps["gather brute"].results, gather_default, MODEL_TOL)
    del gather_default
    out["sub_grid"] = {
        "candidates": total, "device_vs_host_max_abs_err": err_dh, "device_vs_host_tied": n_dh,
        "kernel_vs_plain_max_abs_err": err_plain, "kernel_vs_plain_tied": n_tied,
        "factorized_vs_brute_max_abs_err": err_fact, "factorized_vs_brute_tied": n_fact,
        "factorized_default_vs_gather_max_abs_err": err_fd,
        "factorized_default_vs_gather_tied": n_fd,
        "pairs_per_s": {n: r.pairs_per_s for n, r in sweeps.items()}}
    log(f"[screen] sub-grid {C} x {A} x {sub_t} = {total} candidates, top {k}: device vs host "
        f"max|err| {err_dh:.3e} ({n_dh} swapped at the k-th score); pallas_step f32 vs plain gather f32 max|err| "
        f"{err_plain:.3e} ({n_tied} swapped at the k-th score); factorized vs brute force "
        f"max|err| {err_fact:.3e} ({n_fact} swapped), in {dtype} vs gather {dtype} "
        f"{err_fd:.3e} ({n_fd} swapped); pairs/s "
        + json.dumps({n: round(r.pairs_per_s) for n, r in sweeps.items()}))

    # 3. short sweeps in the other kernel configurations
    short = (cations[:SHORT_GRID[0]], anions, sub_temps[:SHORT_GRID[1]])
    n_short = SHORT_GRID[0] * A * SHORT_GRID[1]
    ref = plain.screen_grid(*short, top_k=k, steps_per_call=K)
    out["short"] = {}
    for name, impl, scatter in (("pallas_fused f32", "pallas_fused", "xla"),
                                ("gather+pallas scatter f32", "gather", "pallas")):
        res, counts = counted(f"short sweep {name}", impl, scatter, dispatched(n_short),
                              lambda: engine(impl, "float32", scatter).screen_grid(
                                  *short, top_k=k, steps_per_call=K))
        err, n_tied = hold_top(f"short sweep {name} vs plain", res.results, ref.results,
                               plain, MODEL_TOL)
        out["short"][name] = {"launches": counts, "max_abs_err": err, "tied": n_tied}
        log(f"[screen] short sweep {name} ({n_short} candidates): launches "
            f"{ {k_: v for k_, v in counts.items() if v} }, max|err| {err:.3e} vs plain")
    del f32, plain

    # 4. the BASELINE config-5 sweep: 2,688 x 24 x 156, brute force on the card
    cat_pool = IonPool(cations, vocab)
    n_pairs = len(cat_pool) * A
    n_t = max(1, -(-SCREEN_TARGET // n_pairs))
    temps = np.linspace(273.15, 393.15, n_t).astype(np.float32)
    total = n_pairs * n_t
    replays = -(-total // (B * K))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    report, counts = counted("10M sweep", "pallas_step", "xla", K * replays,
                             lambda: default.screen_grid(cations, anions, temps, top_k=k,
                                                         steps_per_call=K))
    peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    if report.n_screened != total or len(report.results) != k:
        raise AssertionError(f"10M sweep: {report.n_screened} screened, "
                             f"{len(report.results)} results")
    preds = np.array([r.prediction for r in report.results])
    if not np.isfinite(preds).all() or np.any(np.diff(preds) < 0):
        raise AssertionError("10M sweep: predictions not finite and ascending")
    out["sweep"] = {"candidates": total, "cations": len(cat_pool), "anions": A,
                    "temperatures": n_t, "replays": replays, "launches": counts,
                    "pairs_per_s": report.pairs_per_s,
                    "steady_pairs_per_s": report.steady_pairs_per_s,
                    "wall_s": report.wall_s, "device_s": report.device_s,
                    "peak_mib": peak_mib, "skipped": [s for s, _ in report.skipped],
                    "best": [report.results[0].cation, report.results[0].anion,
                             report.results[0].temperature, report.results[0].prediction]}
    log(f"[screen] config-5 sweep: {len(cat_pool)} x {A} x {n_t} = {total:,} candidates "
        f"in {report.wall_s:.3f} s, {replays} replays of one {K}-batch graph "
        f"(fused_mp_step launched {counts['fused_mp_step']} = 8 x {K} x {replays}); "
        f"{report.pairs_per_s:,.1f} pairs/s overall, {report.steady_pairs_per_s:,.1f} "
        f"steady; device+dispatch {report.device_s:.3f} s; peak {peak_mib:.1f} MiB above "
        f"the {mem0 / 2**20:.1f} MiB before; skipped {out['sweep']['skipped']}")

    # per batch inside the sweep: one replay / K, the pack alone, the forward
    # alone (each a graph on the sweep's own plan, CUDA events)
    an_pool = IonPool(anions, vocab)
    big = default._grid_plan(cat_pool, an_pool, n_t, True, True)
    prog = default._device_sweep(cat_pool, an_pool, temps, big, k, True, K)
    prog.scal.copy_(torch.tensor([total // 2, len(cat_pool), A, total], dtype=torch.int32))

    def pack_only():
        with torch.inference_mode():
            return prog.pack(prog.scal[0])

    pack_graph = Replay(pack_only, dev, graphed=True)
    static = pack_only()
    fwd_graph = Replay(lambda: default._forward(static), dev, graphed=True)
    times = {"replay": forward_times(prog.run, n=20), "pack": forward_times(pack_graph),
             "forward": forward_times(fwd_graph)}
    per_batch = {"batch_ms": times["replay"]["wall_ms"] / K,
                 "pack_ms": times["pack"]["wall_ms"], "forward_ms": times["forward"]["wall_ms"],
                 "replay_host_ms": times["replay"]["host_ms"]}
    out["per_batch"] = dict(per_batch, cation_N=big.node_cap, cation_E=big.edge_cap,
                            anion_N=big.anion_node_cap, anion_E=big.anion_edge_cap)
    log(f"[screen] per batch of {B} inside the sweep (plan cation N={big.node_cap} "
        f"E={big.edge_cap}, anion N={big.anion_node_cap} E={big.anion_edge_cap}): "
        f"{per_batch['batch_ms']:.4f} ms (one replay {times['replay']['wall_ms']:.4f} ms / "
        f"{K}, host {per_batch['replay_host_ms']:.4f} ms to enqueue it); the pack alone "
        f"{per_batch['pack_ms']:.4f} ms, the forward alone {per_batch['forward_ms']:.4f} ms "
        f"(graphs)")

    # 5. the host path on ~200k candidates
    host_grid = (cations, anions, temps[:: max(1, n_t // HOST_GRID_T)][:HOST_GRID_T])
    n_host = len(cat_pool) * A * HOST_GRID_T
    hrep, _ = counted("host path", "pallas_step", "xla", -(-n_host // B),
                      lambda: default.screen_grid(*host_grid, top_k=k, device_pack=False))
    drep = default.screen_grid(*host_grid, top_k=k, steps_per_call=K)
    err_h, n_h = hold_top("host path vs device sweep", hrep.results, drep.results, default,
                          MODEL_TOL)
    out["host_path"] = {"candidates": n_host, "pairs_per_s": hrep.pairs_per_s,
                        "producer_wait_s": hrep.producer_wait_s, "device_s": hrep.device_s,
                        "wall_s": hrep.wall_s, "device_sweep_pairs_per_s": drep.pairs_per_s,
                        "vs_device_max_abs_err": err_h, "vs_device_tied": n_h}
    log(f"[screen] host path (native packer, producer thread): {n_host:,} candidates in "
        f"{hrep.wall_s:.3f} s, {hrep.pairs_per_s:,.1f} pairs/s; the consumer waited "
        f"{hrep.producer_wait_s:.3f} s on packing, {hrep.device_s:.3f} s on the card; the "
        f"device sweep of the same grid {drep.pairs_per_s:,.1f} pairs/s; max|err| {err_h:.3e} "
        f"against it, {n_h} swapped at the k-th score")

    # 6. the factorized sweep over the 10M grid
    fact = default.screen_grid_factorized(cations, anions, temps, top_k=k)
    key = lambda r: (r.cation, r.anion, r.temperature)
    brute = {key(r): r.prediction for r in report.results}
    diffs = [abs(r.prediction - brute[key(r)]) for r in fact.results if key(r) in brute]
    out["factorized"] = {"seconds": fact.wall_s, "pairs_per_s": fact.pairs_per_s,
                         "shared_with_brute": len(diffs),
                         "shared_max_abs_diff": max(diffs, default=None)}
    # not held: in bf16 the factorized sweep's gather trunk rounds where
    # pallas_step does not (the sub-grid holds each against its own formulation)
    log(f"[screen] factorized sweep over the same {total:,} candidates: {fact.wall_s:.3f} s "
        f"({fact.pairs_per_s:,.1f} pairs/s); {len(diffs)} of its top {k} in the brute "
        f"force's ({dtype}), max |diff| {max(diffs, default=float('nan')):.3e} on those")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[screen] phase {out['seconds']:.1f} s")

    def profile():
        prof = device_profile(prog.run, n=5, warmup=2)
        wall = times["replay"]["wall_ms"]
        res = {"busy_ms_per_replay": prof["busy_ms"], "replay_wall_ms": wall,
               "busy_share": min(1.0, prof["busy_ms"] / wall),
               "top": {k_[:60]: v for k_, v in list(prof["by_kernel"].items())[:6]}}
        log(f"[screen] profiler: busy {prof['busy_ms']:.4f} ms per replay of {K} batches "
            f"against a {wall:.4f} ms wall, busy share {res['busy_share']:.3f}; top kernels "
            f"ms: " + json.dumps({k_: round(v, 5) for k_, v in res["top"].items()}))
        return res

    return out, launches, profile


# ---------------------------------------------------------------- [dp]

DP_K = 8  # train steps per replay of the data-parallel step, as the default
DP_TIMED_ITERS = 10
DP_GLOO_STEPS = 2  # steps of each 2-rank gloo arm
DP_GLOO_RANKS = 2
DP_GLOO_FIT_RECORDS = (512, 64)  # train, dev records of the 2-rank gloo fit
DP_FIT_EPOCHS = 2  # resumed after the first
DP_SCREEN_CATIONS = 128  # x 24 anions: the fan-out's candidates
DP_TIMEOUT_S = 900


def _dp_prepare(rank):
    """A rank's setup: plain references in exact f32, as in main()."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _dp_counts(batches):
    return float(sum(float(np.sum(b.sample_mask)) for b in batches))


def _dp_launches_exact(tag, counts, steps, impl, scatter):
    per_step, _ = kernel_launches(impl, scatter)
    want = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {want}")


def _dp_screen_check(tag, mesh, base_dict, world):
    """``ScreeningEngine(mesh=)``'s ``predict_batch`` against the single
    engine on the same weights, over ``world`` sub-batches (the last one
    short)."""
    from ionic_mpnn_torch.config import model_config_from_dict
    from ionic_mpnn_torch.data import BatchPlan
    from ionic_mpnn_torch.inference import ScreeningEngine
    from ionic_mpnn_torch.models import ViscosityModel

    cations, anions, vocab = screen_library(DP_SCREEN_CATIONS)
    anions = [a for a in anions if a != UNPARSED_ANION]
    cands = [(c, a, 273.15 + (i % 7) * 20.0)
             for i, (c, a) in enumerate((c, a) for c in cations for a in anions)]
    B = SCREEN_BATCH
    n = min(len(cands), B * world - B // 2) if world > 1 else B
    cands = cands[:n]
    cfg = model_config_from_dict(base_dict).replace(
        atom_vocab_size=vocab.atom_vocab_size, bond_vocab_size=vocab.bond_vocab_size,
        message_impl="pallas_step")
    state = ViscosityModel(cfg, seed=0).state_dict()
    plan = BatchPlan(B, B * 128, B * 256)
    fan = ScreeningEngine(ViscosityModel(cfg, seed=0), state, vocab, plan, mesh=mesh)
    single = ScreeningEngine(ViscosityModel(cfg, seed=0), state, vocab, plan)
    with deterministic():  # the readout's sums in one order in both engines
        got = fan.predict_batch(cands)
        want = np.concatenate([single.predict_batch(cands[i:i + B]) for i in range(0, n, B)])
    err = float(np.max(np.abs(got - want)))
    if got.shape != want.shape or not np.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{tag}: fan-out against the single engine, max |err| {err}")
    return {"candidates": n, "max_abs_err": err, "ranks": fan.n_dev,
            "compute_dtype": cfg.compute_dtype, "predictions": got}


def _dp_all_reduce_profile(flat, group, n=20):
    """``all_reduce(flat)`` alone: the card's kernels under the profiler
    (none at all where NCCL has nothing to do) and the call's wall time."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        dist.all_reduce(flat, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dist.all_reduce(flat, group=group)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            dist.all_reduce(flat, group=group)
        torch.cuda.synchronize()
    kernels_ = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3 / n
            kernels_[e.name[:60]] = kernels_.get(e.name[:60], 0.0) + ms
    return {"floats": flat.numel(), "bytes": 4 * flat.numel(), "wall_ms": wall_ms,
            "device_ms": sum(kernels_.values()), "kernels": kernels_}


def dp_nccl_rank(rank, world, dev, base_dict, hb, fit_args, ckpt_dir):
    """[dp] over NCCL, one rank per card: the K-step DP graph against the
    eager DP step and (one rank) the single-device step, bit for bit; the DP
    step's times and its all-reduce's device time beside the single-device
    step's; fit(mesh=) on the host loader and on paired device epochs
    against fit() without a mesh and resumed; the screening fan-out.
    ``base_dict`` is the config of the bench vocab (``hb``'s), the last of
    ``fit_args`` that of the fit records."""
    import tempfile

    from ionic_mpnn_torch.benchmarks.harness import _count_message_edges, _time_calls
    from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.parallel import make_dp_train_step, make_mesh
    from ionic_mpnn_torch.training import fit, make_train_step

    dev = _dp_prepare(rank)
    mesh = make_mesh()
    cfg = model_config_from_dict(base_dict).replace(message_impl="pallas_step",
                                                    compute_dtype="bfloat16")
    state = ViscosityModel(cfg, seed=0).state_dict()

    def model():
        m = ViscosityModel(cfg, seed=0)
        m.load_state_dict(state)
        return m

    out = {"rank": rank, "world": world, "backend": "nccl", "K": DP_K, "batch": BATCH}
    launches = {}

    def count(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- the K-step DP graph against the eager DP step (and one rank against
    # the single-device step): two calls each, the first captures
    kernels.reset_launch_counts()
    runs = {}
    with deterministic():
        for tag, jit in (("graphed", True), ("eager", False)):
            step = make_dp_train_step(model(), cfg, TrainConfig(), mesh=mesh,
                                      steps_per_call=DP_K, jit_compile=jit)
            if step.graphed != (jit and dev.type == "cuda"):
                raise AssertionError(f"[dp] {tag}: the NCCL step graphed={step.graphed}")
            res = [step.scan(hb) for _ in range(2)]
            runs[tag] = _runner_state(step, torch.cat([r["losses"] for r in res]),
                                      res[0]["ns"] + res[1]["ns"])
        if world == 1:
            step = make_train_step(model(), cfg, TrainConfig(steps_per_call=DP_K))
            res = [step.scan(hb) for _ in range(2)]
            runs["single-device"] = _runner_state(step, torch.cat([r["losses"] for r in res]),
                                                  res[0]["ns"] + res[1]["ns"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    _dp_launches_exact("[dp] nccl steps", counts, sum(r["steps"] for r in runs.values()),
                       "pallas_step", "xla")
    count(counts)
    if runs["graphed"]["steps"] != 2 * DP_K:
        raise AssertionError(f"[dp] {runs['graphed']['steps']} graphed DP steps")
    for tag in [t for t in runs if t != "graphed"]:
        _same_runner_state(f"[dp] graphed DP step against {tag}", runs["graphed"], runs[tag])
    out["bit_equal"] = sorted(t for t in runs if t != "graphed")
    out["losses"] = runs["graphed"]["losses"].tolist()
    if rank == 0:
        log(f"[dp] rank 0: the graphed DP step equals {out['bit_equal']} bit for bit")

    # -- times: the DP step (K per replay) beside the single-device step
    me = int(np.mean([_count_message_edges(b, cfg.num_steps) for b in hb]))
    mine = hb[rank::world]
    ns = [_dp_counts(hb[s * world:(s + 1) * world]) for s in range(DP_K)]
    times = {}
    kernels.reset_launch_counts()
    dp_step = make_dp_train_step(model(), cfg, TrainConfig(), mesh=mesh, steps_per_call=DP_K)
    g = dp_step.graphs(mine[0])
    g.slots.copy_into(mine)
    g.set_counts(ns)
    calls = {"dp": lambda: dp_step.run_slots(g, DP_K)[:, 0]}
    one = make_train_step(model(), cfg, TrainConfig(steps_per_call=DP_K))
    g1 = one.graphs(mine[0])
    g1.slots.copy_into(mine)
    calls["single-device"] = lambda: one.run_slots(g1, DP_K)[:, 0]
    for tag, call in calls.items():
        r = _time_calls(call, dev, DP_K, me * (world if tag == "dp" else 1), BATCH,
                        iters=DP_TIMED_ITERS, warmup=2, sync_each=True)
        r["wall_ms"] = r["call_ms"] / DP_K
        times[tag] = r
    torch.cuda.synchronize()
    count(kernels.launch_counts())
    for tag, call in calls.items():
        prof = device_profile(call, n=3, warmup=1)
        nccl = {k: v for k, v in prof["by_kernel"].items() if "nccl" in k.lower()}
        times[tag].update(busy_ms=prof["busy_ms"] / DP_K,
                          all_reduce_ms=sum(nccl.values()) / DP_K,
                          all_reduce_kernels={k[:60]: v / DP_K for k, v in nccl.items()},
                          top={k[:60]: v / DP_K for k, v in list(prof["by_kernel"].items())[:6]},
                          idle_share=max(0.0, 1 - prof["busy_ms"] / DP_K
                                         / times[tag]["wall_ms"]))
    # the step's all-reduce alone, eagerly, on the same buffer
    alone = _dp_all_reduce_profile(dp_step._flat, dp_step.axis.group)
    out["all_reduce_alone"] = alone
    if times["dp"]["all_reduce_ms"] <= 0 and (world > 1 or alone["kernels"]):
        raise AssertionError(f"[dp] the profiler saw no NCCL kernel in the DP step's replay "
                             f"(the all-reduce alone: {alone})")
    out["times"] = {k: {f: v[f] for f in ("wall_ms", "call_ms", "host_ms", "busy_ms",
                                           "idle_share", "edges_per_s", "all_reduce_ms",
                                           "all_reduce_kernels", "top")}
                    for k, v in times.items()}
    out["message_edges_per_step"] = me * world
    out["grad_floats"] = dp_step._n_grad
    if rank == 0:
        log(f"[dp] rank 0: times {json.dumps(out['times'])}; all-reduce alone "
            f"{json.dumps(alone)}")

    # -- fit(mesh=) at [fit]'s recipe, both loaders
    train, dev_split, host_plan, aligned_plan, fit_base = fit_args
    fcfg0 = model_config_from_dict(fit_base).replace(compute_dtype="bfloat16")
    arms = {"pallas_step bf16, host loader": (fcfg0.replace(message_impl="pallas_step"),
                                              host_plan, "native"),
            "onehot bf16 w64, paired device epochs": (
                fcfg0.replace(message_impl="onehot", onehot_window=DE_WINDOW), aligned_plan,
                "device_paired")}
    out["fit"] = {}
    for tag, (fcfg, fplan, loader) in arms.items():
        def run(epochs, mesh_=mesh, **kw):
            m = ViscosityModel(fcfg, seed=0)  # the same seeded weights in every run
            return fit(m, fcfg, TrainConfig(epochs=epochs, batch_size=FIT_BATCH, seed=0, **kw),
                       train, dev_split, fplan, verbose=False, mesh=mesh_)

        kernels.reset_launch_counts()
        with deterministic():
            whole = run(DP_FIT_EPOCHS)
            ck = f"{ckpt_dir}/{len(out['fit'])}"
            run(DP_FIT_EPOCHS - 1, checkpoint_dir=ck, checkpoint_every=1)
            resumed = run(DP_FIT_EPOCHS, checkpoint_dir=ck)
            if world == 1:
                same_fit(f"[dp] fit(mesh=) {tag} against no mesh", whole,
                         run(DP_FIT_EPOCHS, mesh_=None))
        if whole.loader != loader or whole.world_size != world:
            raise AssertionError(f"[dp] fit {tag}: loader {whole.loader}, world "
                                 f"{whole.world_size}")
        same_fit(f"[dp] fit(mesh=) {tag} resumed against uninterrupted", whole, resumed)
        timed = {"mesh": epoch_summary(run(DP_FIT_EPOCHS)),
                 "no mesh": epoch_summary(run(DP_FIT_EPOCHS, mesh_=None))}
        torch.cuda.synchronize()
        count(kernels.launch_counts())
        out["fit"][tag] = {"loss": whole.history["loss"], "val_loss": whole.history["val_loss"],
                           "steps": whole.steps, "loader": whole.loader, "epochs": timed,
                           "equal_to_no_mesh": world == 1}
        if rank == 0:
            log(f"[dp] rank 0: fit(mesh=) {tag}: {json.dumps(out['fit'][tag]['epochs'])}")

    # -- the screening fan-out
    kernels.reset_launch_counts()
    scr = _dp_screen_check("[dp] ScreeningEngine(mesh=) nccl", mesh, base_dict, world)
    count(kernels.launch_counts())
    scr.pop("predictions")
    out["screen"] = scr
    out["launches"] = launches
    return out


def dp_gloo_rank(rank, world, dev, base_dict, hb, fit_args):
    """[dp] over gloo, ranks sharing one card (eager: gloo cannot be
    captured): per arm, DP_GLOO_STEPS steps against the accumulated
    single-process reference; a few steps of fit(mesh=); the screening
    fan-out. The parent holds the ranks against each other."""
    from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.parallel import make_dp_train_step, make_mesh
    from ionic_mpnn_torch.training import data_loss_sum, fit, l2_penalty, make_optimizer

    dev = _dp_prepare(rank)
    mesh = make_mesh(device_type="cuda")
    base = model_config_from_dict(base_dict)
    batches = hb[:world * DP_GLOO_STEPS]
    out = {"rank": rank, "world": world, "backend": "gloo", "arms": {}}
    launches = {}
    for tag, impl, scatter in (("pallas_step f32", "pallas_step", "xla"),
                               ("gather+pallas scatter f32", "gather", "pallas")):
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype="float32")
        state = ViscosityModel(cfg, seed=0).state_dict()
        m = ViscosityModel(cfg, seed=0)
        m.load_state_dict(state)
        step = make_dp_train_step(m, cfg, TrainConfig(), mesh=mesh, steps_per_call=1)
        if step.graphed:
            raise AssertionError("[dp] a gloo step would capture")
        kernels.reset_launch_counts()
        losses, walls = [], []
        with deterministic():
            for s in range(DP_GLOO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step.scan(batches[s * world:(s + 1) * world])["losses"])
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        wall_ms = walls[-1]  # the first step also sets up cuBLAS and the gloo pairs
        counts = kernels.launch_counts()
        _dp_launches_exact(f"[dp] gloo {tag}", counts, DP_GLOO_STEPS, impl, scatter)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        arm = {"losses": torch.cat(losses).tolist(), "step_wall_ms": wall_ms,
               "params": {k: v.detach().cpu().numpy() for k, v in m.state_dict().items()}}
        if rank == 0:  # Σ local_sum / N + L2 over each step's batches, in one process
            ref = ViscosityModel(cfg, seed=0)
            ref.load_state_dict(state)
            opt = make_optimizer(ref.parameters())
            with deterministic():
                for s in range(DP_GLOO_STEPS):
                    group = [b.to(dev) for b in batches[s * world:(s + 1) * world]]
                    ref.train()
                    opt.zero_grad()
                    total = sum(data_loss_sum(ref(b)["pred"], b.y, b.sample_mask, "mse", 1.0)
                                for b in group)
                    (total / _dp_counts(batches[s * world:(s + 1) * world])
                     + l2_penalty(ref, cfg.fp_l2)).backward()
                    opt.step()
            worst = 0.0
            for k, want in ref.state_dict().items():
                got = m.state_dict()[k]
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                worst = max(worst, err / max(scale, 1e-30))
                if err > 1e-5 * scale:
                    raise AssertionError(f"[dp] gloo {tag}: {k} {err:.3e} from the accumulated "
                                         f"reference, beyond 1e-5 of its max {scale:.3e}")
            arm["worst_of_max"] = worst
        out["arms"][tag] = arm
        if rank == 0:
            log(f"[dp] gloo rank 0: {tag} losses {arm['losses']}, worst "
                f"{arm['worst_of_max']:.3e} of max, {wall_ms:.3f} ms per step")

    # -- a few steps of fit(mesh=) over gloo on the card
    train, dev_split, host_plan, _, fit_base = fit_args
    n_train, n_dev = DP_GLOO_FIT_RECORDS
    cfg = model_config_from_dict(fit_base).replace(message_impl="pallas_step",
                                                   compute_dtype="float32")
    m = ViscosityModel(cfg, seed=0)
    kernels.reset_launch_counts()
    with deterministic():
        res = fit(m, cfg, TrainConfig(epochs=1, batch_size=FIT_BATCH, seed=0),
                  train[:n_train], dev_split[:n_dev], host_plan, verbose=False, mesh=mesh)
    for k, v in kernels.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    out["fit"] = {"loss": res.history["loss"], "steps": res.steps, "world_size": res.world_size,
                  "params": {k: v.cpu().numpy() for k, v in res.params.items()}}
    kernels.reset_launch_counts()
    out["screen"] = _dp_screen_check("[dp] ScreeningEngine(mesh=) gloo", mesh, base_dict,
                                     world)
    out["screen"].pop("predictions")
    for k, v in kernels.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def phase_dp(records, plan, vocab, fit_data, beside):
    """[dp]: the data-parallel tier (``ionic_mpnn_torch/parallel``) on the
    card, in ranks that ``run_local`` spawns: NCCL over every card, then 2
    gloo ranks on card 0, beside the functions in ``beside`` (name ->
    function of no arguments; nothing that times a comparison). Returns its
    record, the kernel launches its ranks made (summed over ranks) and
    ``{name: (value, seconds)}`` of ``beside``."""
    import tempfile

    from ionic_mpnn_torch.config import model_config_to_dict, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.parallel import run_local

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    n = max(world, DP_GLOO_RANKS) * DP_K
    # [graphs]' timed batches: distinct packings of the bench batch's records
    hb = [next(iter_batches(records[:BATCH], plan, shuffle=True, seed=s)) for s in range(n)]
    base = model_config_to_dict(viscosity_config(vocab.atom_vocab_size,
                                                 vocab.bond_vocab_size))
    fvocab = fit_data["vocab"]
    fit_base = model_config_to_dict(viscosity_config(fvocab.atom_vocab_size,
                                                     fvocab.bond_vocab_size))
    aligned = plan_capacities(fit_data["records"], FIT_BATCH, edge_layout="window_aligned",
                              window=DE_WINDOW)
    fit_args = (fit_data["train"], fit_data["dev"], fit_data["plan"], aligned, fit_base)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        nccl = run_local(dp_nccl_rank, world, "nccl", "cuda", base, hb[:world * DP_K],
                         fit_args, ckpt, timeout_s=DP_TIMEOUT_S)
        nccl_s = time.perf_counter() - t0
    side = run_together({"dp gloo": lambda: run_local(
        dp_gloo_rank, DP_GLOO_RANKS, "gloo", "cuda", base, hb, fit_args,
        timeout_s=DP_TIMEOUT_S), **beside})
    gloo, gloo_s = side.pop("dp gloo")

    first = nccl[0]
    for r in nccl[1:]:
        if r["losses"] != first["losses"]:
            raise AssertionError(f"[dp] nccl rank {r['rank']}: losses differ from rank 0's")
    for tag in gloo[0]["arms"]:
        for k, v in gloo[0]["arms"][tag]["params"].items():
            if not np.array_equal(v, gloo[1]["arms"][tag]["params"][k]):
                raise AssertionError(f"[dp] gloo {tag}: the ranks' {k} differ")
    for k, v in gloo[0]["fit"]["params"].items():
        if not np.array_equal(v, gloo[1]["fit"]["params"][k]):
            raise AssertionError(f"[dp] gloo fit: the ranks' best {k} differ")
    launches = {}
    for r in nccl + gloo:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if min(launches.get(k, 0) for k in ("fused_mp_step", "fused_message_aggregate",
                                        "fused_message_aggregate_dh",
                                        "sorted_segment_sum")) <= 0:
        raise AssertionError(f"[dp] a kernel of the path never launched: {launches}")

    t = first["times"]
    log(f"[dp] NCCL over {world} rank(s), pallas_step bf16, batch {BATCH} per rank, K = "
        f"{DP_K}: the graphed DP step equals, bit for bit over {2 * DP_K} steps, "
        f"{', '.join(first['bit_equal'])} (losses, parameters, both moments, the count)")
    for tag, r in t.items():
        log(f"[dp] train step {tag}: wall {r['wall_ms']:.4f} ms per step (a call "
            f"{r['call_ms']:.4f} ms, median of {DP_TIMED_ITERS}), host {r['host_ms']:.4f} ms, "
            f"busy {r['busy_ms']:.4f} ms, idle share {r['idle_share']:.3f}, "
            f"{r['edges_per_s']:.6e} message-edges/s, all-reduce {r['all_reduce_ms']:.5f} ms "
            f"of device time per step ({first['grad_floats']} gradient floats + 2)")
    a = first["all_reduce_alone"]
    log(f"[dp] the step's all-reduce alone ({a['bytes']} bytes, eager): {a['wall_ms']:.5f} ms "
        f"per call on the host clock, {a['device_ms']:.5f} ms of device time in kernels "
        f"{json.dumps(a['kernels'])}")
    for tag, f in first["fit"].items():
        log(f"[dp] fit(mesh=) {tag}, world {world}: loader {f['loader']}, {f['steps']} steps, "
            f"loss {f['loss']}; resumed at epoch {DP_FIT_EPOCHS - 1} equals uninterrupted"
            + (", and the history equals fit() without a mesh, bit for bit"
               if f["equal_to_no_mesh"] else "")
            + f"; steady epoch {f['epochs']['mesh']['epoch_s']:.4f} s with the mesh, "
            f"{f['epochs']['no mesh']['epoch_s']:.4f} s without")
    for tag, a in gloo[0]["arms"].items():
        log(f"[dp] gloo, {DP_GLOO_RANKS} ranks on one card, {tag}: {DP_GLOO_STEPS} steps, "
            f"losses {a['losses']}, parameters within {a['worst_of_max']:.3e} of each "
            f"tensor's max of the accumulated reference (bound 1e-5), ranks bit-equal; "
            f"step wall {a['step_wall_ms']:.3f} ms (a record, not a target)")
    log(f"[dp] gloo fit(mesh=): {gloo[0]['fit']['steps']} steps, loss "
        f"{gloo[0]['fit']['loss']}, the ranks' best weights equal bit for bit")
    for tag, s in (("nccl", first["screen"]), ("gloo", gloo[0]["screen"])):
        log(f"[dp] ScreeningEngine(mesh=) {tag}, {s['ranks']} rank(s): {s['candidates']} "
            f"candidates, max |err| {s['max_abs_err']:.3e} against the single engine "
            f"(rtol/atol 1e-5)")
    log(f"[dp] launches, summed over ranks: {launches}; nccl ranks {nccl_s:.1f} s, gloo ranks "
        f"{gloo_s:.1f} s (beside {sorted(side)}), phase {time.perf_counter() - t_phase:.1f} s")
    for r in gloo:
        for a in r["arms"].values():
            a.pop("params")
        r["fit"].pop("params")
    return ({"nccl": nccl, "gloo": gloo, "seconds": {"nccl": nccl_s, "gloo": gloo_s}},
            launches, side)


# ---------------------------------------------------------------- [ep]

EP_K = 4  # train steps per replay of the NCCL EP step
EP_CALLS = 2  # scans of EP_K steps per NCCL arm: the first captures, the second replays
EP_TIMED_ITERS = 5
EP_GLOO_STEPS = 2  # steps of each gloo arm
EP_WINDOW = 64  # the bf16 onehot window of the aligned arms
EP_SHARDS = 2  # node shards of the aligned batches (the 2-rank arm and DP x EP's model axis)
# The gloo arms' first check: the gradients of step 1, summed over the group
# (before the optimizer's clip), against the single-process reference's
# .grad in the same dtype, at most this share of each tensor's max. Each is
# the largest reading of the sound runs on the card at batch 2048, rounded
# up (PERF.md §6). The f32 readings peak in the gradients summed over
# every edge or node, whose order the shard cut changes (the CPU tests hold
# 1e-5 at a small batch); the bf16 reference computes in bf16. A gradient
# without its group sum reads 0.5 of its max or more, a zero one 1.
EP_GRAD_TOL = {"float32": 5e-5, "bfloat16": 1e-2}
# The second check: (rtol, atol) of the parameters after the gloo steps
# against the reference. The clip makes an Adam step lr·sign(g), so this
# sees a gradient's sign, not its size: f32 JAX's EP oracle's
# (tests/test_ep_train.py); bf16 [train]'s rtol, and as atol the furthest
# two Adam steps of rate 1e-3 can drive an element apart
EP_TOL = {"float32": (2e-3, 3e-6), "bfloat16": (2e-2, 4e-3)}
EP_TIMEOUT_S = 600
EP_NCCL_ARMS = (  # (name, message_impl, scatter_impl, compute_dtype)
    ("pallas_fused f32", "pallas_fused", "xla", "float32"),
    ("pallas_fused bf16", "pallas_fused", "xla", "bfloat16"),
    ("gather+pallas scatter f32", "gather", "pallas", "float32"))
EP_GLOO_ARMS = {  # ranks: (name, tier, message_impl, scatter_impl, compute_dtype)
    2: (("EP v1 pallas_fused f32", "ep", "pallas_fused", "xla", "float32"),
        ("EP v1 gather+pallas scatter f32", "ep", "gather", "pallas", "float32"),
        ("halo gather f32", "halo", "gather", "xla", "float32"),
        ("aligned onehot bf16 w64", "aligned", "onehot", "xla", "bfloat16"),
        ("TP model_parallel=2 pallas_fused f32", "tp", "pallas_fused", "xla", "float32")),
    4: (("DPxEP 2x2 aligned onehot bf16 w64", "dpxep", "onehot", "xla", "bfloat16"),),
}


def _ep_worst(got, want, dtype):
    """The largest ``|got - want| / (atol + rtol·|want|)`` over the tensors'
    elements (at most 1 within EP_TOL[dtype])."""
    rtol, atol = EP_TOL[dtype]
    return max(float(((g.float() - w.float()).abs() / (atol + rtol * w.float().abs())).max())
               for g, w in zip(got, want))


def _grad_worst(got, want):
    """The largest ``max|got - want| / max|want|`` over the tensors of
    ``want`` (every one must be in ``got``), and the tensor's name."""
    return max((float((got[k].float() - w.float()).abs().max())
                / max(float(w.abs().max()), 1e-30), k) for k, w in want.items())


def _record_grads(step, model, grads, local):
    """Keep step 1's gradients as the optimizer sees them (``grads``: summed
    over the group, before its clip) and, for a partitioned step, as this
    rank held them just before the sum (``local``: what a missing group sum
    would leave)."""
    opt_step = step.optimizer.step

    def record_step():
        if not grads:
            grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        opt_step()

    step.optimizer.step = record_step
    if hasattr(step, "_flat"):  # the flat gradient buffer's one all-reduce
        all_reduce = step.comm.all_reduce

        def record_sum(t):
            if not local and t.numel() == step._flat.numel():
                local.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
            return all_reduce(t)

        step.comm.all_reduce = record_sum
    else:  # TP: replicated compute, each rank's own gradient is the step's
        def keep(name):
            def hook(p):
                if name not in grads:
                    grads[name] = p.grad.detach().clone()
            return hook

        for n, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(keep(n))


def _tally_line(stats):
    return {k: [len(v), sum(v)] for k, v in stats.items() if isinstance(v, list) and v}


def _add(into, counts):
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def ep_nccl_rank(rank, world, dev, base_dict, hb):
    """[ep] over NCCL, one rank per card: per arm, the K-step EP graph
    against the eager EP step and (one rank) the single-device step, over
    EP_CALLS·EP_K steps, launches exact; the EP step's times and its
    all-reduces' device time beside the single-device step's."""
    from ionic_mpnn_torch.benchmarks.harness import _count_message_edges, _time_calls
    from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.parallel import make_ep_train_step, make_mesh, partition_batch_edges
    from ionic_mpnn_torch.training import make_train_step

    dev = _dp_prepare(rank)
    mesh = make_mesh()
    base = model_config_from_dict(base_dict)
    parted = [partition_batch_edges(b, world) for b in hb]
    me = int(np.mean([_count_message_edges(b, base.num_steps) for b in hb]))
    out = {"rank": rank, "world": world, "K": EP_K, "arms": {}, "message_edges_per_step": me}
    launches = {}
    for tag, impl, scatter, dtype in EP_NCCL_ARMS:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        ep_cfg = cfg.replace(ep_axis="data")
        state = ViscosityModel(cfg, seed=0).state_dict()

        def model(c):
            m = ViscosityModel(c, seed=0)
            m.load_state_dict(state)
            return m

        kernels.reset_launch_counts()
        runs, steps = {}, {}
        with deterministic():
            for jtag, jit in (("graphed", True), ("eager", False)):
                steps[jtag] = make_ep_train_step(model(ep_cfg), ep_cfg, TrainConfig(), mesh=mesh,
                                                 steps_per_call=EP_K, jit_compile=jit)
                if steps[jtag].graphed != (jit and dev.type == "cuda"):
                    raise AssertionError(f"[ep] {tag} {jtag}: graphed={steps[jtag].graphed}")
                res = [steps[jtag].scan(parted) for _ in range(EP_CALLS)]
                runs[jtag] = _runner_state(steps[jtag], torch.cat([r["losses"] for r in res]),
                                           sum((r["ns"] for r in res), []))
            if world == 1:
                single = make_train_step(model(cfg), cfg, TrainConfig(steps_per_call=EP_K))
                res = [single.scan(hb) for _ in range(EP_CALLS)]
                runs["single-device"] = _runner_state(single, torch.cat([r["losses"] for r in res]),
                                                      sum((r["ns"] for r in res), []))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        _dp_launches_exact(f"[ep] nccl {tag}", counts, sum(r["steps"] for r in runs.values()),
                           impl, scatter)
        _add(launches, counts)
        if runs["graphed"]["steps"] != EP_CALLS * EP_K:
            raise AssertionError(f"[ep] {tag}: {runs['graphed']['steps']} graphed steps")
        arm = {"losses": runs["graphed"]["losses"].tolist(), "bit_equal": [], "worst": {}}
        for other in [t for t in runs if t != "graphed"]:
            a, b = runs["graphed"], runs[other]
            worst = _ep_worst(a["params"], b["params"], dtype)
            arm["worst"][other] = worst
            if world == 1 or worst == 0.0:
                _same_runner_state(f"[ep] {tag}: graphed EP step against {other}", a, b)
                arm["bit_equal"].append(other)
            elif worst > 1.0:  # several cards: the ring may sum in another order
                raise AssertionError(f"[ep] {tag}: graphed against {other}: {worst:.3e} of "
                                     f"the bound {EP_TOL[dtype]}")

        # times, outside deterministic mode (a graph captured inside it
        # replays the sort-based index_add_): a fresh graphed EP step
        # beside the single-device step on the whole batches, EP_K steps
        # per replay each
        ep_step = make_ep_train_step(model(ep_cfg), ep_cfg, TrainConfig(), mesh=mesh,
                                     steps_per_call=EP_K)
        local = [ep_step._local(p) for p in parted]
        g = ep_step.graphs(local[0][0])
        g.slots.copy_into([b for b, _ in local])
        g.set_counts([n for _, n in local])
        single = make_train_step(model(cfg), cfg, TrainConfig(steps_per_call=EP_K))
        g1 = single.graphs(hb[0])
        g1.slots.copy_into(hb)
        calls = {"ep": lambda: ep_step.run_slots(g, EP_K)[:, 0],
                 "single-device": lambda: single.run_slots(g1, EP_K)[:, 0]}
        kernels.reset_launch_counts()
        timed = {k: _time_calls(c, dev, EP_K, me, BATCH, iters=EP_TIMED_ITERS, warmup=1,
                                sync_each=True) for k, c in calls.items()}
        torch.cuda.synchronize()
        _add(launches, kernels.launch_counts())
        arm["times"] = {}
        for k, call in calls.items():
            prof = device_profile(call, n=3, warmup=1)
            nccl = {n[:60]: v / EP_K for n, v in prof["by_kernel"].items()
                    if "nccl" in n.lower()}
            wall = timed[k]["call_ms"] / EP_K
            arm["times"][k] = {
                "wall_ms": wall, "host_ms": timed[k]["host_ms"],
                "busy_ms": prof["busy_ms"] / EP_K,
                "idle_share": max(0.0, 1 - prof["busy_ms"] / EP_K / wall),
                "edges_per_s": timed[k]["edges_per_s"], "all_reduce_ms": sum(nccl.values()),
                "all_reduce_kernels": nccl,
                "top": {n[:60]: v / EP_K for n, v in list(prof["by_kernel"].items())[:6]}}
        out["arms"][tag] = arm
        if rank == 0:
            log(f"[ep] nccl rank 0: {tag}: graphed equals {arm['bit_equal']} bit for bit")
    out["launches"] = launches
    return out


def _ep_reference(cfg, state, groups, dev):
    """The single-process reference on the card: per step, Σ local_sum / N
    + L2 over the step's batches (one batch: the single-device step). Its
    parameters after the steps, and its gradients of step 1 before the
    optimizer."""
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import data_loss_sum, l2_penalty, make_optimizer

    ref = ViscosityModel(cfg, seed=0)
    ref.load_state_dict(state)
    opt = make_optimizer(ref.parameters())
    grads = {}
    with deterministic():
        for group in groups:
            ref.train()
            opt.zero_grad()
            total = sum(data_loss_sum(ref(b)["pred"], b.y, b.sample_mask, "mse", 1.0)
                        for b in (b.to(dev) for b in group))
            (total / _dp_counts(group) + l2_penalty(ref, cfg.fp_l2)).backward()
            if not grads:
                grads = {n: p.grad.detach().clone() for n, p in ref.named_parameters()
                         if p.grad is not None}
            opt.step()
    return ref.state_dict(), grads


def ep_gloo_rank(rank, world, dev, base_dict, hb, ab, arms):
    """[ep] over gloo, ranks sharing one card (eager): per arm
    EP_GLOO_STEPS steps, the first tallied; rank 0 holds the gradients of
    step 1 and the parameters after the steps to the single-process
    reference on the card, and checks that the gradient bound would see a
    missing group sum. The parent holds the ranks against each other."""
    from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.parallel import (collective_stats, make_aligned_ep_train_step,
                                           make_ep_train_step, make_halo_ep_train_step, make_mesh,
                                           make_tp_train_step, partition_batch_edges,
                                           partition_halo_batch, shard_aligned_batch,
                                           stack_aligned_dp_batches)

    dev = _dp_prepare(rank)
    base = model_config_from_dict(base_dict)
    out = {"rank": rank, "world": world, "arms": {}}
    launches = {}
    for tag, tier, impl, scatter, dtype in arms:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        if impl == "onehot":
            cfg = cfg.replace(onehot_window=EP_WINDOW)
        state = ViscosityModel(cfg, seed=0).state_dict()
        ep_cfg = cfg.replace(ep_axis={"ep": "data", "aligned": "data", "dpxep": "ep"}.get(tier))
        m = ViscosityModel(ep_cfg, seed=0)
        m.load_state_dict(state)
        tc = TrainConfig()
        if tier == "ep":
            step = make_ep_train_step(m, ep_cfg, tc, mesh=make_mesh(device_type="cuda"))
            groups = [[b] for b in hb[:EP_GLOO_STEPS]]
            inputs = [partition_batch_edges(g[0], world) for g in groups]
        elif tier == "halo":
            step = make_halo_ep_train_step(m, cfg, tc, mesh=make_mesh(device_type="cuda"))
            groups = [[b] for b in hb[:EP_GLOO_STEPS]]
            inputs = [partition_halo_batch(g[0], world) for g in groups]
        elif tier == "aligned":
            step = make_aligned_ep_train_step(m, ep_cfg, tc, mesh=make_mesh(device_type="cuda"))
            groups = [[b] for b in ab[:EP_GLOO_STEPS]]
            inputs = [shard_aligned_batch(g[0], world, EP_WINDOW) for g in groups]
        elif tier == "tp":
            step = make_tp_train_step(m, cfg, tc, mesh=make_mesh(
                MeshConfig(data_parallel=1, model_parallel=world), device_type="cuda"))
            groups = [[b] for b in hb[:EP_GLOO_STEPS]]
            inputs = [g[0] for g in groups]
        else:  # dpxep
            n_dp = world // EP_SHARDS
            step = make_aligned_ep_train_step(
                m, ep_cfg, tc, mesh=make_mesh(MeshConfig(data_parallel=n_dp,
                                                         model_parallel=EP_SHARDS,
                                                         model_axis="ep"), device_type="cuda"),
                axis="ep", dp_axis="data")
            groups = [ab[s * n_dp:(s + 1) * n_dp] for s in range(EP_GLOO_STEPS)]
            inputs = [stack_aligned_dp_batches(g, EP_SHARDS, EP_WINDOW) for g in groups]
        if step.graphed:
            raise AssertionError(f"[ep] {tag}: a gloo step would capture")
        grads, local = {}, {}
        _record_grads(step, m, grads, local)
        kernels.reset_launch_counts()
        walls = []
        with deterministic():
            for s, x in enumerate(inputs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if s == 0:
                    stats = collective_stats(step, x)
                else:
                    step(x)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        counts = kernels.launch_counts()
        _dp_launches_exact(f"[ep] gloo {tag}", counts, EP_GLOO_STEPS, impl, scatter)
        _add(launches, counts)
        got = step.state_dict() if tier == "tp" else m.state_dict()
        arm = {"tally": _tally_line(stats), "step_wall_ms": walls[-1], "counts": counts,
               "dtype": dtype,
               "params": {k: v.detach().cpu().numpy() for k, v in got.items()}}
        if rank == 0:
            want, want_grads = _ep_reference(cfg, state, groups, dev)
            bound = EP_GRAD_TOL[dtype]
            arm["grad_worst"], arm["grad_worst_at"] = _grad_worst(grads, want_grads)
            if arm["grad_worst"] > bound:
                raise AssertionError(f"[ep] gloo {tag}: summed gradient of "
                                     f"{arm['grad_worst_at']} {arm['grad_worst']:.3e} of its max "
                                     f"from the single-process reference, beyond {bound}")
            if local:  # the bound would see the gradient without its group sum
                arm["grad_unsummed"] = _grad_worst(local, want_grads)[0]
                if arm["grad_unsummed"] <= bound:
                    raise AssertionError(f"[ep] gloo {tag}: the unsummed gradient reads "
                                         f"{arm['grad_unsummed']:.3e}, within the bound {bound}")
            worst = _ep_worst([got[k] for k in want], list(want.values()), dtype)
            if worst > 1.0:
                raise AssertionError(f"[ep] gloo {tag}: parameters {worst:.3e} of the bound "
                                     f"(rtol, atol) {EP_TOL[dtype]} from the single-process "
                                     f"reference")
            arm["worst"] = worst
            log(f"[ep] gloo rank 0 of {world}: {tag}: gradients {arm['grad_worst']:.3e} of "
                f"max at {arm['grad_worst_at']} (bound {bound}; unsummed {arm.get('grad_unsummed', 'n/a')}), "
                f"parameters {worst:.3e} of the bound {EP_TOL[dtype]}, launches {counts}, "
                f"tally of step 1 {arm['tally']}, {walls[-1]:.1f} ms per step")
        out["arms"][tag] = arm
    out["launches"] = launches
    return out


def ep_side_calls(records, plan, vocab):
    """[ep]'s gloo ranks (2 and 4 on card 0) and, on one card, its one-step
    run of the scaling harness, as functions of no arguments that
    ``phase_dp`` runs beside its own gloo ranks: none of them is timed for
    a comparison. Returns them and the inputs ``phase_ep`` shares."""
    from ionic_mpnn_torch.benchmarks.scaling import run_scaling_benchmark
    from ionic_mpnn_torch.config import model_config_to_dict, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.parallel import run_local

    # [graphs]' packings of the bench batch; the aligned ones fold into EP_SHARDS
    hb = [next(iter_batches(records[:BATCH], plan, shuffle=True, seed=s))
          for s in range(max(EP_K, EP_GLOO_STEPS))]
    aplan = plan_capacities(records[:BATCH], BATCH, edge_layout="window_aligned",
                            window=EP_WINDOW, node_shards=EP_SHARDS)
    ab = [next(iter_batches(records[:BATCH], aplan, shuffle=True, seed=s))
          for s in range(2 * EP_GLOO_STEPS)]
    base = model_config_to_dict(viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size))
    calls = {f"ep gloo {n}": (lambda n=n, arms=arms: run_local(
        ep_gloo_rank, n, "gloo", "cuda", base, hb, ab, arms, timeout_s=EP_TIMEOUT_S))
        for n, arms in EP_GLOO_ARMS.items()}
    if torch.cuda.device_count() == 1:  # one mode, one timed step, to show it runs
        calls["ep scaling"] = lambda: {"dp": run_scaling_benchmark(mode="dp", iters=1,
                                                                   warmup=1)}
    return calls, (hb, base)


def phase_ep(inputs, side):
    """[ep]: the model-parallel tier (EP v1, halo, aligned, DP x EP, TP) on
    the card, in ranks that ``run_local`` spawns: NCCL over every card;
    the 2 and 4 gloo ranks on card 0 ran beside [dp]'s (``side``: the
    values and seconds of ``ep_side_calls``); then the scaling harness.
    Returns its record and the kernel launches of its ranks (summed)."""
    from ionic_mpnn_torch.benchmarks.scaling import MODES, run_scaling_benchmark
    from ionic_mpnn_torch.parallel import run_local

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    hb, base = inputs
    seconds = {}
    t0 = time.perf_counter()
    nccl = run_local(ep_nccl_rank, world, "nccl", "cuda", base, hb[:EP_K],
                     timeout_s=EP_TIMEOUT_S)
    seconds["nccl"] = time.perf_counter() - t0
    gloo = {}
    for n in EP_GLOO_ARMS:
        gloo[n], seconds[f"gloo {n} (beside [dp]'s gloo ranks)"] = side[f"ep gloo {n}"]

    for r in nccl[1:]:
        for tag, a in r["arms"].items():
            if a["losses"] != nccl[0]["arms"][tag]["losses"]:
                raise AssertionError(f"[ep] nccl rank {r['rank']} {tag}: losses differ")
    for n, ranks in gloo.items():
        for tag, a in ranks[0]["arms"].items():
            for r in ranks[1:]:
                for k, v in a["params"].items():
                    if not np.array_equal(v, r["arms"][tag]["params"][k]):
                        raise AssertionError(f"[ep] gloo {tag}: rank {r['rank']}'s {k} differs")
    launches = {}
    for r in nccl + [r for ranks in gloo.values() for r in ranks]:
        _add(launches, r["launches"])
    if min(launches.get(k, 0) for k in ("fused_message_aggregate", "fused_message_aggregate_dh",
                                        "sorted_segment_sum")) <= 0:
        raise AssertionError(f"[ep] a kernel of the path never launched: {launches}")
    t0 = time.perf_counter()
    if world > 1:  # the sweep over the counts this machine has, at the bench batch
        scaling = {mode: run_scaling_benchmark(per_device_batch=BATCH, mode=mode)
                   for mode in MODES}
        seconds["scaling"] = time.perf_counter() - t0
    else:  # one rank scales by definition: one mode, one timed step, to show it runs
        scaling, seconds["scaling (beside [dp]'s gloo ranks)"] = side["ep scaling"]
        log("[ep] scaling: one card, so the harness runs once (dp, one step); the sweep "
            "needs several cards")

    first = nccl[0]
    log(f"[ep] NCCL over {world} rank(s), batch {BATCH}, EP_K = {EP_K}, "
        f"{first['message_edges_per_step']} message edges per step:")
    for tag, a in first["arms"].items():
        log(f"[ep] EP v1 {tag}: the graphed step equals {a['bit_equal']} bit for bit over "
            f"{EP_CALLS * EP_K} steps (worst of the bound {a['worst']})")
        for k, t in a["times"].items():
            log(f"[ep] EP v1 {tag}, {k} step (K = {EP_K} per replay): wall "
                f"{t['wall_ms']:.4f} ms per step, host {t['host_ms']:.4f} ms, busy "
                f"{t['busy_ms']:.4f} ms, idle share {t['idle_share']:.3f}, "
                f"{t['edges_per_s']:.6e} message-edges/s, all-reduces "
                f"{t['all_reduce_ms']:.5f} ms of device time per step")
    for n, ranks in gloo.items():
        for tag, a in ranks[0]["arms"].items():
            log(f"[ep] gloo, {n} ranks on card 0, {tag}: {EP_GLOO_STEPS} steps, step 1's "
                f"summed gradients at {a['grad_worst']:.3e} of a tensor's max "
                f"({a['grad_worst_at']}; bound "
                f"{EP_GRAD_TOL[a['dtype']]}; without the group sum "
                f"{a.get('grad_unsummed', 'n/a')}), parameters at {a['worst']:.3e} of the "
                f"bound (rtol, atol) {EP_TOL[a['dtype']]} from the single-process reference, "
                f"ranks bit-equal, launches per rank {a['counts']}; collectives of "
                f"step 1 per rank [count, bytes] {json.dumps(a['tally'])}; step wall "
                f"{a['step_wall_ms']:.1f} ms (a record, not a target)")
    for mode, s in scaling.items():
        log(f"[ep] scaling {mode} on {s['device']}: "
            + json.dumps(s["strong_scaling" if mode == "aligned_ep" else "weak_scaling"]))
    log(f"[ep] launches, summed over ranks: {launches}; seconds {json.dumps(seconds)}, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for ranks in gloo.values():
        for r in ranks:
            for a in r["arms"].values():
                a.pop("params")
    return {"nccl": nccl, "gloo": {str(n): v for n, v in gloo.items()}, "scaling": scaling,
            "seconds": seconds}, launches


# ---------------------------------------------------------------- [phases]

PHASES_WINDOW = 64  # the bf16 onehot window (resolve_onehot_window)
# the phase-cut forward's "fwd" against the model's loss: JAX's own bounds
# (tests/test_phases.py), bf16 and f32
PHASES_TOL = {"bfloat16": 3e-2, "float32": 1e-5}
PHASES_TIMED = 20
PHASES_TRACE_STEPS = 2


def phases_trace_child(log_dir):
    """Run in a process of its own by [phases] (CUPTI stays attached to a
    process once the profiler ran, and would slow every wall time [times]
    takes after it): two graphed ``pallas_step`` bf16 train steps at batch
    2048, their graphs captured first, inside ``utils.trace(log_dir)``.
    Prints one JSON line: the launch counts of every step it ran and the
    trace file's name and kernel events."""
    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import make_train_step
    from ionic_mpnn_torch.utils import trace

    records, vocab = make_bench_dataset(BATCH, seed=0)
    plan = plan_capacities(records, BATCH, headroom=2.0)
    batches = list(iter_batches(records, plan, shuffle=True, seed=0))[:1] * 2
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                           message_impl="pallas_step", compute_dtype="bfloat16")
    step = make_train_step(ViscosityModel(cfg, seed=0), cfg, TrainConfig())
    kernels.reset_launch_counts()
    for batch in batches:  # the first call runs eagerly and captures; then replays
        step(batch)
    torch.cuda.synchronize()
    with trace(log_dir):
        for batch in batches[:PHASES_TRACE_STEPS]:
            loss = step(batch)["loss"]
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    print(json.dumps({"launches": counts, "steps": len(batches) + PHASES_TRACE_STEPS,
                      "loss": float(loss), "files": [f.name for f in files],
                      "bytes": files[0].stat().st_size if files else 0,
                      "kernel_events": sum(names.values()),
                      "fused_events": sum(v for k, v in names.items()
                                          if "fused_message_tc_kernel" in k)}), flush=True)


def phase_phases(records, vocab, state, dev):
    """[phases]: the phase-cut forward (``benchmarks/phases.py``) on the
    bench batch of 2048, onehot on window_aligned batches at window 64:
    every phase finite, ``fwd`` equal to the model's loss (bf16 3e-2, f32
    1e-5), each phase's forward time (CUDA events) and the deltas between
    phases; then ``utils.trace`` around two graphed ``pallas_step`` bf16
    train steps in a process of its own, whose trace file must name
    ``fused_message_tc_kernel``."""
    import tempfile

    from ionic_mpnn_torch.benchmarks.phases import PHASES, phase_forward
    from ionic_mpnn_torch.config import viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import data_loss, l2_penalty

    t_phase = time.perf_counter()
    plan = plan_capacities(records, BATCH, headroom=2.0, edge_layout="window_aligned",
                           window=PHASES_WINDOW)
    batch = next(iter_batches(records, plan)).to(dev)
    out = {"window": PHASES_WINDOW, "batch": BATCH}
    for dtype, tol in PHASES_TOL.items():
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                               message_impl="onehot", compute_dtype=dtype,
                               onehot_window=PHASES_WINDOW)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        model.eval()
        params = dict(model.named_parameters())
        with torch.inference_mode():
            pred = model(batch)["pred"]
            want = float(data_loss(pred, batch.y, batch.sample_mask, "mse", 1.0)
                         + l2_penalty(model, cfg.fp_l2))
            values = {p: float(phase_forward(params, cfg, batch, p)) for p in PHASES}
            ms = {p: time_ms(lambda p=p: phase_forward(params, cfg, batch, p), n=PHASES_TIMED)
                  for p in PHASES}
        bad = [p for p, v in values.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"[phases] {dtype}: non-finite phases {bad}: {values}")
        got = values["fwd"]
        if abs(got - want) > tol * (1 + abs(want)):
            raise AssertionError(f"[phases] {dtype}: fwd {got!r} against the model's loss "
                                 f"{want!r} (rtol/atol {tol})")
        deltas = {f"{a}->{b}": ms[b] - ms[a] for a, b in zip(PHASES, PHASES[1:])}
        out[dtype] = {"fwd": got, "model_loss": want, "values": values, "ms": ms,
                      "delta_ms": deltas}
        log(f"[phases] {dtype}: fwd {got!r} = the model's loss {want!r} (|err| "
            f"{abs(got - want):.3e}, rtol/atol {tol}); forward ms per phase "
            + json.dumps({p: round(v, 4) for p, v in ms.items()}) + "; deltas ms "
            + json.dumps({k: round(v, 4) for k, v in deltas.items()}))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke as c; c.phases_trace_child(sys.argv[1])",
             tmp], cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"[phases] the trace process exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
    per_step, _ = kernel_launches("pallas_step", "xla")
    want = {k: child["steps"] * per_step.get(k, 0) for k in child["launches"]}
    if child["launches"] != want:
        raise AssertionError(f"[phases] trace process: launches {child['launches']}, "
                             f"expected {want}")
    if len(child["files"]) != 1 or child["fused_events"] < PHASES_TRACE_STEPS * 24:
        raise AssertionError(f"[phases] the trace names no fused_message_tc_kernel launch of "
                             f"the traced steps: {child}")
    out["trace"] = dict(child, seconds=time.perf_counter() - t0)
    log(f"[phases] utils.trace around {PHASES_TRACE_STEPS} graphed pallas_step bf16 train "
        f"steps (a process of its own): {child['files'][0]} ({child['bytes']} bytes), "
        f"{child['kernel_events']} kernel events, {child['fused_events']} of them "
        f"fused_message_tc_kernel; launches over its {child['steps']} steps "
        f"{child['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phases] phase {out['seconds']:.1f} s")
    return out, dict(child["launches"])


# ---------------------------------------------------------------- [quality]

# the published protocol (the JAX package's scripts/quality_protocols.py):
# 7666 viscosity rows, 400 melting-point draws, 400 / 300 epochs, patience
# 50, warm-up 1000, seed 0, batch 1024, all three tasks and splits
QUALITY_ARGS = ["--n-viscosity", "7666", "--n-mp", "400", "--epochs-viscosity", "400",
                "--epochs-mp", "300", "--warmup", "1000", "--seed", "0", "--batch-size",
                "1024", "--tasks", "viscosity,mp,transfer", "--splits", "random,pair,family"]
# [protocols]: the same data, splits, tasks and start, each fit cut to 2 epochs
PROTOCOLS_EPOCHS = ["--epochs-viscosity", "2", "--epochs-mp", "2"]
# the viscosity model starts from the weights the JAX protocol draws at seed
# 0 (tools/export_jax_init.py wrote them), the start of JAX's own row, and
# the run is deterministic: the recipe's viscosity outcome turns on rounding
# (its dev loss swings 10x between epochs, early stopping keeps the lowest),
# so without both a single reading is a draw, not a property of the tree
QUALITY_START = ["--init-from", "tools/quality_init_seed0.npz",  # the CLI runs in HERE
                 "--deterministic"]
# random-split test R² each model must reach; the JAX package's rows at
# seed 0 (docs/quality_protocols_r5.json) read 0.6054, 0.954 and 0.9272
QUALITY_GATES = {"viscosity": 0.50, "mp": 0.85, "transfer": 0.85}
QUALITY_TIMEOUT = 600
QUALITY_REFERENCE = HERE / "docs" / "quality_protocols_r5.json"
# CHAIN_NO_JAX, with matplotlib blocked too (the card machine has none)
QUALITY_NO_JAX = CHAIN_NO_JAX.replace("'ionic_mpnn_tpu')", "'ionic_mpnn_tpu', 'matplotlib')")


def quality_run(tmp, args):
    """The quality CLI in a process of its own with JAX and matplotlib
    blocked: ``(rows file, the kernel launches line, seconds, stdout)``."""
    out = Path(tmp) / f"rows_{len(list(Path(tmp).iterdir()))}.json"
    cmd = [sys.executable, "-c", QUALITY_NO_JAX, "ionic_mpnn_torch.cli.quality_protocols",
           *args, "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=QUALITY_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[quality] exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-4000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    if not last.startswith("kernel launches "):
        raise AssertionError(f"[quality] the last line is not the launch counts: {last!r}")
    return (json.loads(out.read_text()), json.loads(last[len("kernel launches "):]), seconds,
            proc.stdout)


def quality_expected(fits):
    """The exact launches of the CLI's fits: per train step phase 6's
    counts (viscosity and mp) or [transfer]'s per stage, and 8
    ``fused_mp_step`` per forward of each epoch's dev eval and of the
    evaluation."""
    per_step, per_fwd = kernel_launches("pallas_step", "xla")
    want = {k: 0 for k in TRANSFER_LAUNCHES[1]}
    for f in fits:
        stages = ([TRANSFER_LAUNCHES[1], TRANSFER_LAUNCHES[2]] if f["task"] == "transfer"
                  else [per_step])
        if len(stages) != len(f["stages"]):
            raise AssertionError(f"[quality] {f['task']} {f['split']}: stages {f['stages']}")
        forwards = f["eval_batches"]
        for counts, s in zip(stages, f["stages"]):
            forwards += s["dev_batches"] * s["epochs"]
            for k in want:
                want[k] += s["train_steps"] * counts.get(k, 0)
        for k in want:
            want[k] += forwards * per_fwd.get(k, 0)
    return want


def _row_line(r):
    return (f"test R2 {r['test_r2']} MAE {r['test_mae']}, dev R2 {r['dev_r2']} MAE "
            f"{r['dev_mae']}, train R2 {r['train_r2']} MAE {r['train_mae']}")


def phase_quality(gated=False):
    """[protocols] (``gated`` false): the quality-protocol CLI
    (``cli.quality_protocols``) on the card at the published data sizes with
    each fit cut to 2 epochs, in a process of its own with JAX and
    matplotlib blocked, in the default CUDA configuration from QUALITY_START
    (JAX's seed-0 viscosity weights, deterministic): every row beside the
    JAX package's row of the same task and split, the split sizes equal to
    JAX's, every metric finite, the launch counts exact and no
    ``sorted_segment_sum``. [quality] (``gated``): the same at the
    published depth, and the random split's test R² at least QUALITY_GATES;
    a row that misses its gate is run again in plain ``gather`` f32 on the
    card, both rows printed, before the phase fails."""
    import tempfile

    tag = "[quality]" if gated else "[protocols]"
    args = QUALITY_ARGS + QUALITY_START + ([] if gated else PROTOCOLS_EPOCHS)
    t_phase = time.perf_counter()
    reference = {(r["task"], r["split"]): r
                 for r in json.loads(QUALITY_REFERENCE.read_text())["rows"]}
    with tempfile.TemporaryDirectory() as tmp:
        rows, line, seconds, stdout = quality_run(tmp, args)
        cfg = {k: rows[k] for k in ("message_impl", "dtype", "batch_size", "label_mode")}
        if cfg != {"message_impl": "pallas_step", "dtype": "bfloat16", "batch_size": 1024,
                   "label_mode": "hard"}:
            raise AssertionError(f"{tag} ran {cfg}, not the default CUDA configuration")
        launches, want = line["launches"], quality_expected(line["fits"])
        out = {"seconds": seconds, "config": cfg, "args": args, "rows": rows["rows"],
               "fits": line["fits"], "launches": launches}
        if len(rows["rows"]) != len(reference):
            raise AssertionError(f"{tag} {len(rows['rows'])} rows, JAX's file has "
                                 f"{len(reference)}")
        for r in rows["rows"]:
            j = reference[(r["task"], r["split"])]
            log(f"{tag} {r['task']} {r['split']}: n {r['n']}, epochs "
                f"{r.get('epochs_run', '-')}, {r['wall_s']} s; {_row_line(r)}")
            log(f"{tag}   JAX's row (onehot bf16, seed 0): {_row_line(j)}")
            if r["n"] != j["n"]:
                raise AssertionError(f"{tag} {r['task']} {r['split']}: split sizes {r['n']}, "
                                     f"JAX's {j['n']}")
            bad = [k for k, v in r.items() if k.endswith(("_r2", "_mae"))
                   and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"{tag} {r['task']} {r['split']}: non-finite {bad}")
        log(f"{tag} {len(rows['rows'])} rows in {seconds:.1f} s; launches {launches}, "
            f"expected {want}")
        if launches != want:
            raise AssertionError(f"{tag} launch counts {launches}, expected {want} from "
                                 f"{line['fits']}")
        if launches["sorted_segment_sum"] != 0 or not launches["fused_mp_step"] > 0:
            raise AssertionError(f"{tag} launches {launches}")
        misses = [r for r in rows["rows"] if gated and r["split"] == "random"
                  and r["test_r2"] < QUALITY_GATES[r["task"]]]
        for r in misses:
            plain, _, s, _ = quality_run(tmp, QUALITY_ARGS[:-4] + [
                "--tasks", r["task"], "--splits", "random", "--message-impl", "gather",
                "--dtype", "float32", *QUALITY_START])
            p = next(x for x in plain["rows"] if x["task"] == r["task"])
            log(f"{tag} {r['task']} random MISSES its gate {QUALITY_GATES[r['task']]}: "
                f"pallas_step bf16 {_row_line(r)}; plain gather f32 on the card ({s:.1f} s) "
                f"{_row_line(p)}")
        if misses:
            raise AssertionError(f"{tag} random-split test R2 below its gate: "
                                 + ", ".join(f"{r['task']} {r['test_r2']}" for r in misses))
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"{tag} phase {out['phase_seconds']:.1f} s")
    return out, {k: v for k, v in launches.items()}


# ---------------------------------------------------------------- [dryrun]

DRYRUN_GLOO_RANKS = 2
DRYRUN_NUM_STEPS = 2  # the dry run's model: 2 message steps (JAX's)


def dryrun_expected(r):
    """Each arm's exact launches in one rank of the dry run: the DP step's
    one train step and the checkpointed fits' steps (phase 6's per-step
    counts at 2 message steps), a forward of 2 message steps per ion for
    each of the sharded eval's forwards (its own and one per shard) and each
    dev batch of the fits' 3 epochs; none in the onehot, gather and plain
    arms."""
    per_step, per_fwd = kernel_launches(r["message_impl"], "xla")
    scale = DRYRUN_NUM_STEPS / 4
    zero = {k: 0 for k in TRANSFER_LAUNCHES[1]}

    def counts(steps, forwards):
        return {k: int(scale * (steps * per_step.get(k, 0) + forwards * per_fwd.get(k, 0)))
                for k in zero}

    want = {arm: dict(zero) for arm in r["arms"]}
    want["dp"] = counts(1, 0)
    want["sharded-eval"] = counts(0, 1 + r["world"])
    f = r["fit"]
    want["ckpt-resume"] = counts(f["steps"][1], (len(f["first"]) + 1) * f["dev_batches"])
    return want


def phase_dryrun(dev):
    """[dryrun]: the driver's entry points (``ionic_mpnn_torch/dryrun.py``).
    ``entry()`` on the card (``pallas_step`` bf16, the resolved config)
    against plain ``gather`` f32 reading the bf16-rounded tensors at
    [main]'s tolerance, 8 ``fused_mp_step``; then ``dryrun_multichip`` on
    one NCCL rank per card and on 2 gloo ranks on card 0 (eager), every arm
    of the JAX dry run, its sharded eval equal to the single-device forward
    of each shard, the launches of each arm exact. The NCCL and gloo runs
    go side by side; so may other work that touches no launch count of
    this process."""
    from ionic_mpnn_torch import dryrun
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    fn, (model, batch) = dryrun.entry()
    cfg = model.cfg
    if (cfg.message_impl, cfg.compute_dtype, cfg.atom_dim) != ("pallas_step", "bfloat16", 32):
        raise AssertionError(f"[dryrun] entry() built {cfg.message_impl} "
                             f"{cfg.compute_dtype} D={cfg.atom_dim}")
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = fn(model, batch)
    launches = kernels.launch_counts()
    if launches != {k: (8 if k == "fused_mp_step" else 0) for k in launches}:
        raise AssertionError(f"[dryrun] entry(): launches {launches}, expected 8 fused_mp_step")
    plain = ViscosityModel(cfg.replace(message_impl="gather", compute_dtype="float32"))
    plain.load_state_dict(model.state_dict())
    round_in_every_forward(plain)
    with torch.inference_mode():
        want = plain(batch)["pred"]
    err = close("[dryrun] entry() pallas_step bf16", got, want, *MODEL_TOL)
    out = {"entry": {"pred": got.float().cpu().tolist(), "max_abs_err": err}}
    log(f"[dryrun] entry(): {cfg.message_impl} {cfg.compute_dtype} on {len(got)} records, "
        f"8 fused_mp_step, max |err| {err:.3e} against plain gather f32 with the bf16-rounded "
        f"tensors (rtol/atol {MODEL_TOL[0]})")
    world = torch.cuda.device_count()
    arms = (("nccl", world, "nccl"), ("gloo", DRYRUN_GLOO_RANKS, "gloo"))
    ran = run_together({tag: (lambda n=n, backend=backend: dryrun.dryrun_multichip(
        n, backend, "cuda")) for tag, n, backend in arms})
    for tag, n, backend in arms:
        ranks, seconds = ran[tag]
        for r in ranks:
            want = dryrun_expected(r)
            if r["launches"] != want:
                raise AssertionError(f"[dryrun] {tag} rank {r['rank']}: launches per arm "
                                     f"{r['launches']}, expected {want}")
            for counts in r["launches"].values():
                _add(launches, counts)
        r = ranks[0]
        log(f"[dryrun] {tag}, {n} rank(s), {r['message_impl']} f32: dp loss {r['dp_loss']:.6f}, "
            f"onehot {r['onehot_loss']:.6f}, halo {r['halo_loss']:.6f}, aligned "
            f"{r['aligned_loss']:.6f}" + (f", tp {r['tp_loss']:.6f}, dpxep {r['dpxep_loss']:.6f}"
                                          if "tp_loss" in r else "")
            + f"; device epochs {r['de_n']:.0f} records once; sharded eval "
            f"{r['eval_preds'].shape} within {r['eval_err']:.3e} of the single-device forward "
            f"per shard (rtol {dryrun.EVAL_RTOL}, atol {dryrun.EVAL_ATOL}); the resumed fit ran "
            f"epoch 3 alone; {seconds:.1f} s")
        out[tag] = {"ranks": n, "seconds": seconds, "arms": r["arms"],
                    "dp_loss": r["dp_loss"], "eval_err": r["eval_err"],
                    "launches": [x["launches"] for x in ranks]}
    out["seconds"] = time.perf_counter() - t_phase
    if not min(launches[k] for k in ("fused_mp_step", "fused_message_aggregate",
                                     "fused_message_aggregate_dh")) > 0:
        raise AssertionError(f"[dryrun] a kernel of the path never launched: {launches}")
    log(f"[dryrun] launches {launches}; phase {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------- [demo]

DEMO_NOTEBOOK = HERE / "examples" / "demo_torch.ipynb"
# the JAX notebook's outputs (examples/demo.ipynb), quoted for R² only
DEMO_JAX_R2 = {"viscosity Test": 0.4880, "mp Dev": 0.9060, "transfer Dev": 0.8991}


def run_notebook(path, ns):
    """Execute the notebook's code cells in order in ``ns``: per cell its
    seconds and the value of its last expression (None for a cell that ends
    in a statement)."""
    import ast

    cells = [c for c in json.loads(path.read_text())["cells"] if c["cell_type"] == "code"]
    out = []
    for i, cell in enumerate(cells):
        tree = ast.parse("".join(cell["source"]))
        last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
        t0 = time.perf_counter()
        exec(compile(tree, f"{path.name}[{i}]", "exec"), ns)
        value = (eval(compile(ast.Expression(last.value), f"{path.name}[{i}]", "eval"), ns)
                 if last is not None else None)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, value))
    return out


def demo_expected(ns):
    """The notebook's exact launches from what its fits report: per train
    step phase 6's counts (viscosity, mp) or [transfer]'s per stage, 8
    ``fused_mp_step`` per forward of every epoch's dev eval, of each
    ``evaluate_splits`` batch, of the plot cell's predictions (where it
    plotted) and of each screening batch."""
    from ionic_mpnn_torch.data import iter_batches

    per_step, per_fwd = kernel_launches("pallas_step", "xla")
    want = {k: 0 for k in TRANSFER_LAUNCHES[1]}

    def batches(records, plan):
        return sum(1 for _ in iter_batches(records, plan))

    def add(counts, n):
        for k in want:
            want[k] += n * counts.get(k, 0)

    plan, mp_plan = ns["plan"], ns["mp_plan"]
    mp_dev_batches = batches(ns["mp_dev"], mp_plan)
    for res, dev_batches, per in ((ns["result"], batches(ns["dev"], plan), per_step),
                                  (ns["mp_result"], mp_dev_batches, per_step),
                                  (ns["tr_result"].stage1, mp_dev_batches, TRANSFER_LAUNCHES[1]),
                                  (ns["tr_result"].stage2, mp_dev_batches, TRANSFER_LAUNCHES[2])):
        add(per, res.steps)
        add(per_fwd, res.epochs_run * dev_batches)
    forwards = sum(batches(ns[k], plan) for k in ("train", "dev", "test")) + 2 * mp_dev_batches
    if "p_tr" in ns:  # the plot cell ran its predictions
        forwards += batches(ns["train"], plan) + batches(ns["dev"], plan)
    forwards += -(-len(ns["cands"]) // ns["splan"].batch_size)
    add(per_fwd, forwards)
    return want


def _epoch_s(res):
    return statistics.median(res.history["epoch_seconds"][1:]) if res.epochs_run > 1 else None


def phase_demo():
    """[demo]: the port's notebook (``examples/demo_torch.ipynb``) at its own
    sizes, its code cells run in order in one namespace in a temporary
    working directory: the default CUDA configuration, the cells' seconds,
    the viscosity model's Train/Dev/Test R² and MAE and the Dev R² of the
    melting-point and transfer models beside the JAX notebook's outputs
    (no gate: each is a draw of the recipe), the screening top 10, and the
    launch counts exact."""
    import os
    import tempfile

    from ionic_mpnn_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    ns = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels.reset_launch_counts()
            cells = run_notebook(DEMO_NOTEBOOK, ns)
            launches = kernels.launch_counts()
        finally:
            os.chdir(cwd)
    names = ["knobs", "data", "viscosity", "plots", "melting point", "transfer", "screening"]
    if len(cells) != len(names):
        raise AssertionError(f"[demo] {len(cells)} code cells, expected {len(names)}")
    cfg = ns["cfg"]
    if (ns["DEVICE"], cfg.message_impl, cfg.compute_dtype) != ("cuda", "pallas_step",
                                                                 "bfloat16"):
        raise AssertionError(f"[demo] ran {ns['DEVICE']} {cfg.message_impl} {cfg.compute_dtype}")
    if cells[1][1] != (2000, 300, 22, 6):
        raise AssertionError(f"[demo] the data cell gave {cells[1][1]}, not (2000, 300, 22, 6)")
    vis, mp, tr, top = cells[2][1], cells[4][1], cells[5][1], cells[6][1]
    for what, metrics in (("viscosity", vis), ("mp", mp), ("transfer", tr)):
        bad = [s for s, m in metrics.items() if not (np.isfinite(m["r2"])
                                                      and np.isfinite(m["mae"]))]
        if bad:
            raise AssertionError(f"[demo] {what}: non-finite metrics on {bad}: {metrics}")
    if len(top) != 10 or not all(np.isfinite(p) for _, _, p in top):
        raise AssertionError(f"[demo] the screening cell gave {top}")
    want = demo_expected(ns)
    if launches != want:
        raise AssertionError(f"[demo] launch counts {launches}, expected {want}")
    res, mp_res, tr_res = ns["result"], ns["mp_result"], ns["tr_result"]
    out = {"cells_s": {n: s for n, (s, _) in zip(names, cells)}, "viscosity": vis, "mp": mp,
           "transfer": tr, "top": top, "launches": launches,
           "epochs": {"viscosity": res.epochs_run, "mp": mp_res.epochs_run,
                      "transfer": [tr_res.stage1.epochs_run, tr_res.stage2.epochs_run]},
           "epoch_s": {"viscosity": _epoch_s(res), "mp": _epoch_s(mp_res),
                       "transfer stage 1": _epoch_s(tr_res.stage1),
                       "transfer stage 2": _epoch_s(tr_res.stage2)},
           "loader": res.loader, "steps_per_call": res.steps_per_call}
    log(f"[demo] cells (s): " + json.dumps({n: round(s, 3) for n, s in out["cells_s"].items()}))
    log(f"[demo] viscosity ({cfg.message_impl} {cfg.compute_dtype}, batch {ns['BATCH']}, "
        f"{res.loader} loader, K = {res.steps_per_call}): {res.epochs_run} epochs, median epoch "
        f"{out['epoch_s']['viscosity']} s; "
        + ", ".join(f"{s} R2 {m['r2']:.4f} MAE {m['mae']:.4f}" for s, m in vis.items())
        + f" (JAX's notebook: Test R2 {DEMO_JAX_R2['viscosity Test']})")
    log(f"[demo] melting point: {mp_res.epochs_run} epochs, median epoch "
        f"{out['epoch_s']['mp']} s; Dev R2 {mp['Dev']['r2']:.4f} MAE {mp['Dev']['mae']:.4f} "
        f"(JAX's notebook: {DEMO_JAX_R2['mp Dev']})")
    log(f"[demo] transfer: {tr_res.stage1.epochs_run} + {tr_res.stage2.epochs_run} epochs, "
        f"median epoch {out['epoch_s']['transfer stage 1']} / "
        f"{out['epoch_s']['transfer stage 2']} s; Dev R2 {tr['Dev']['r2']:.4f} MAE "
        f"{tr['Dev']['mae']:.4f} (JAX's notebook: {DEMO_JAX_R2['transfer Dev']})")
    log(f"[demo] screening top 10: {top}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[demo] launches {launches} (expected from the fits); phase {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------- [host_pipeline]

def phase_host_pipeline():
    """[host_pipeline]: the host-pipeline profile
    (``python -m ionic_mpnn_torch.benchmarks.host_pipeline``) at its
    defaults, 100,000 records, batch 2048, K = 8, the copies to the card:
    each stage's seconds."""
    from ionic_mpnn_torch.benchmarks.host_pipeline import profile_host_pipeline

    t_phase = time.perf_counter()
    out = profile_host_pipeline(device="cuda")
    out["seconds"] = time.perf_counter() - t_phase
    log("[host_pipeline] stage seconds: " + json.dumps(
        {k: out[k] for k in ("dataset_s", "flatten_s", "pack_s", "group_s", "mask_s",
                             "copy_s")})
        + f"; {out['n_batches']} batches of {out['bytes_per_batch']} bytes, "
        f"{out['n_groups']} groups; phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- [bisect]

BISECT_EPOCHS = 12  # of the CLI's 60: depth cut to keep the run inside its limit

def phase_bisect():
    """[bisect]: the quality bisect (``cli/quality_bisect.py``) at its
    default size (1,500 records, the five arms) and ``BISECT_EPOCHS``
    epochs on the card: each arm's line, and no kernel launched (f32
    ``gather`` and ``onehot``)."""
    from ionic_mpnn_torch.cli.quality_bisect import bisect
    from ionic_mpnn_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    lines, t0 = [], t_phase
    # the first arm's seconds include the dataset
    for line in bisect(epochs=BISECT_EPOCHS, device="cuda"):
        line["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        lines.append(line)
        log("[bisect] " + json.dumps(line))
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"[bisect] the arms launched kernels: {launches}")
    if lines[2]["loader"] not in ("device", "device_paired"):
        raise AssertionError(f"[bisect] onehot-dev ran the {lines[2]['loader']} loader")
    bad = [x["arm"] for x in lines if not np.isfinite([x["final_loss"], x["dev_r2"]]).all()]
    if bad:
        raise AssertionError(f"[bisect] non-finite lines: {bad}")
    out = {"lines": lines, "seconds": time.perf_counter() - t_phase}
    log(f"[bisect] launches {launches}; phase {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------- phase 13

def bound_ms(nbytes, flops, adds=0, flops_per_s=F32_FLOPS):
    """The larger of the bytes over the memory rate and the operations over
    their peaks: ``flops`` at ``flops_per_s``, ``adds`` on the f32 CUDA
    cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s + adds / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the fused kernels' and the table gradient's products are f32-accurate on
# the tensor cores: three TF32 passes (the step), or six bf16 products at
# 989e12 / 6 (the message, dK), the same rate; the segment sum is f32 on the
# CUDA cores
TC_F32 = (TF32_FLOPS / 3, "tensor cores, f32-accurate: TF32 / 3")
FLOP_PEAKS = {"fused_message_aggregate": TC_F32, "fused_mp_step": TC_F32,
              "fused_message_aggregate_dh": TC_F32, "fused_message_table_grad": TC_F32,
              "sorted_segment_sum": (F32_FLOPS, "f32 CUDA cores")}


def phase_times(batch, V, models, launches, errs, train_steps, train_batch,
                train_launches, path_launches):
    from ionic_mpnn_torch.benchmarks import time_train_step
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    g = batch.cation
    N, E, D = g.node_capacity, g.edge_capacity, 32
    E_real = int(g.edge_mask.sum())
    gen = torch.Generator().manual_seed(3)
    dev = g.dst.device
    h = torch.randn(N, D, generator=gen).to(dev)
    m_table = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
    gru = gru_params(gen, D, dev)
    K = fused_message.message_table_to_lanes(m_table)
    msg = edge_messages_from_table(h, g.bond_ids, g.src, m_table) * g.edge_mask[:, None]
    cot = torch.randn(N, D, generator=gen).to(dev)  # the cotangent of the aggregate
    Kt = fused_message.transpose_lane_table(K)
    rowptr = segment_sum.csr_rowptr(g.dst, N)
    dst64 = g.dst.long()
    args = (g.bond_ids, g.src, g.dst, g.edge_mask, N)
    edge_bytes = E * (4 + 4 + 4 + 1)  # bond, src, dst, mask
    P = bucket_pairs(g.bond_ids, g.dst, g.edge_mask, V)
    fused = fused_bounds(N, E, E_real, P, D, V)

    # name, source, replaces, CUDA symbol, kernel, plain, library, bytes, flops
    # (at the row's peak), f32 adds (CUDA cores)
    specs = [
        ("sorted_segment_sum", "ionic_mpnn_torch/csrc/segment_sum.cu",
         "ionic_mpnn_tpu/ops/pallas/segment_sum.py:179", "segment_sum_kernel",
         lambda: segment_sum.sorted_segment_sum(msg, g.dst, N, rowptr=rowptr),
         lambda: segment_sum.sorted_segment_sum_plain(msg, g.dst, N),
         lambda: torch.zeros(N, D, device=dev).index_add_(0, dst64, msg),
         E * D * 4 + E * 4 + N * D * 4, E * D, 0),
        ("fused_message_aggregate", "ionic_mpnn_torch/csrc/fused_message.cu",
         FUSED_REPLACES["fused_message_aggregate"], "fused_message_tc_kernel",
         lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
         lambda: fused_message.fused_message_aggregate_plain(h, K, *args),
         None, *fused["fused_message_aggregate"]),
        ("fused_mp_step", "ionic_mpnn_torch/csrc/fused_message.cu",
         FUSED_REPLACES["fused_mp_step"], "fused_message_tc_kernel",
         lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
         lambda: fused_step.fused_mp_step_plain(h, m_table, gru, *args),
         None, *fused["fused_mp_step"]),
        # the backward's dh: the fused-message kernel on (g, Kᵀ); the call
        # includes the transpose of the table
        ("fused_message_aggregate_dh", "ionic_mpnn_torch/csrc/fused_message.cu",
         FUSED_REPLACES["fused_message_aggregate_dh"], "fused_message_tc_kernel",
         lambda: fused_message.message_backward(cot, h, K, *args, rowptr, need_dK=False),
         lambda: fused_message.fused_message_aggregate_plain(cot, Kt, *args),
         None, *fused["fused_message_aggregate_dh"]),
    ]
    # the backward's dK: the table gradient's bucket kernel and the sum of
    # its parts (csrc/table_grad.cu), as message_backward calls it
    dK_call = lambda: fused_message.fused_message_table_grad(cot, h, *args[:4], V, rowptr)
    dK_plain = lambda: fused_message.fused_message_table_grad_plain(cot, h, *args[:4], V)
    # wall-clock timings first: once the profiler has run, CUPTI stays
    # attached to the process and slows every later launch
    with torch.inference_mode():
        call_ms = {spec[0]: time_ms(spec[4]) for spec in specs}
        dK_call_ms = time_ms(dK_call)
        dK_err = check_table_grad(f"cation N={N} E={E} D={D} h float32", cot, h, *args[:4], N,
                                  V, phase="times")
        forward = {name: {"wall_ms": time_ms(lambda: model(batch), n=50)}
                   for name, model in models.items()}
        # the wrapper in inference mode launches directly; .apply forces the
        # autograd Function that training goes through
        gru_values = [gru[k] for k in fused_step.GRU_KEYS]
        overhead = {
            "fused_mp_step": function_overhead(
                lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
                lambda: fused_step.FusedMPStep.apply(h, m_table, *args, 1e-3, rowptr,
                                                     *gru_values)),
            "fused_message_aggregate": function_overhead(
                lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
                lambda: fused_message.FusedMessageAggregate.apply(h, K, *args, rowptr)),
            "sorted_segment_sum": function_overhead(
                lambda: segment_sum.sorted_segment_sum(msg, g.dst, N, rowptr=rowptr),
                lambda: segment_sum.SortedSegmentSum.apply(msg, g.dst, N, rowptr)),
        }
    for name, o in overhead.items():
        log(f"[times] autograd Function overhead {name} (inference mode, N={N}): host "
            f"{o['direct_host_ms']:.5f} ms per launch by the wrapper, "
            f"{o['function_host_ms']:.5f} ms through the Function; call "
            f"{o['direct_call_ms']:.5f} / {o['function_call_ms']:.5f} ms; 8 launches per "
            f"forward through the Function would add "
            f"{8 * (o['function_host_ms'] - o['direct_host_ms']):.5f} ms of host time")
    train = {name: time_train_step(step, train_batch, iters=20, warmup=3)
             for name, step in train_steps.items()}
    rows = []
    for name, source, replaces, symbol, kernel, plain, library, nbytes, flops, adds in specs:
        peak, peak_name = FLOP_PEAKS[name]
        b_ms, b_by = bound_ms(nbytes, flops, adds, peak)
        # for the log: the flops over the f32 CUDA cores
        cores_ms = bound_ms(nbytes, flops + adds)[0]
        ours = {k: v for k, v in device_profile(kernel)["by_kernel"].items() if symbol in k}
        if len(ours) != 1:
            raise AssertionError(f"{name}: expected one {symbol} kernel, got {ours}")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches.get(name, 0) + train_launches.get(name, 0)
                         + sum(p.get(name, 0) for p in path_launches.values())),
            "main_launches": launches.get(name, 0),
            "train_launches": train_launches.get(name, 0),
            **{f"{k}_launches": p.get(name, 0) for k, p in path_launches.items()},
            "max_abs_err": errs[name],
            # the kernel alone on the card; the wrapper call with its host
            # work; the plain version's and the library call's device time
            "ms": next(iter(ours.values())), "call_ms": call_ms[name],
            "plain_ms": device_profile(plain)["device_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "flop_peak": peak_name,
            "library_ms": device_profile(library)["device_ms"] if library else None,
            "shape": {"N": N, "E": E, "E_real": E_real, "P": P, "D": D, "V": V},
        })
        r = rows[-1]
        log(f"[times] {name} N={N} E={E}: kernel {r['ms']:.5f} ms on the card "
            f"(wrapper call {r['call_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
            f"flops over {peak_name}; {cores_ms:.5f} ms with the flops over f32 CUDA cores)")

    name = "fused_message_table_grad"
    b_ms, b_by = bound_ms(*table_grad_bounds(N, E, E_real, P, D, V), TC_F32[0])
    ours = {k: v for k, v in device_profile(dK_call)["by_kernel"].items() if "table_grad" in k}
    if len(ours) != 2:
        raise AssertionError(f"{name}: expected its two kernels, got {ours}")
    plain_prof = device_profile(dK_plain)
    rows.append({
        "name": name, "route": "cuda", "source": TABLE_GRAD_SOURCE,
        "replaces": TABLE_GRAD_REPLACES,
        "launches": (launches.get(name, 0) + train_launches.get(name, 0)
                     + sum(p.get(name, 0) for p in path_launches.values())),
        "main_launches": launches.get(name, 0), "train_launches": train_launches.get(name, 0),
        **{f"{k}_launches": p.get(name, 0) for k, p in path_launches.items()},
        "max_abs_err": dK_err,
        # the bucket kernel and the sum of its parts on the card, each and
        # together; the wrapper call; the plain version's (PyTorch ops) device time
        "ms": sum(ours.values()), "kernels_ms": {k[:60]: v for k, v in ours.items()},
        "call_ms": dK_call_ms, "plain_ms": plain_prof["device_ms"],
        "plain_kernels_ms": {k[:60]: v for k, v in plain_prof["by_kernel"].items()},
        "bound_ms": b_ms, "bound_by": b_by, "flop_peak": TC_F32[1], "library_ms": None,
        "plan": fused_message.table_grad_plan(D, V, N),
        "shape": {"N": N, "E": E, "E_real": E_real, "P": P, "D": D, "V": V},
    })
    r = rows[-1]
    log(f"[times] {name} N={N} E={E}: kernels {r['ms']:.5f} ms on the card "
        + json.dumps({k: round(v, 5) for k, v in r["kernels_ms"].items()})
        + f" (wrapper call {r['call_ms']:.5f} ms), plain (PyTorch ops) {r['plain_ms']:.5f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}), {r['ms'] / b_ms:.2f}x the bound")

    with torch.inference_mode():
        for name, model in models.items():
            prof = device_profile(lambda: model(batch), n=20)
            f = forward[name]
            # busy time from the card's records, wall time from the run
            # without the profiler
            f.update(device_ms=prof["device_ms"], busy_ms=prof["busy_ms"],
                     idle_share=max(0.0, 1 - prof["busy_ms"] / f["wall_ms"]),
                     top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:5]})
            log(f"[times] forward {name}: {f['wall_ms']:.4f} ms per batch of {BATCH} "
                f"(device busy {f['busy_ms']:.4f} ms, idle share {f['idle_share']:.3f}); "
                f"top kernels ms: "
                + json.dumps({k: round(v, 5) for k, v in f["top"].items()}))
    dev_batch = train_batch.to(dev)
    for name, step in train_steps.items():
        prof = device_profile(lambda: step(dev_batch), n=10)
        t = train[name]
        t.update(device_ms=prof["device_ms"], busy_ms=prof["busy_ms"],
                 idle_share=max(0.0, 1 - prof["busy_ms"] / t["step_ms"]),
                 top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
        log(f"[times] train step {name}: {t['step_ms']:.4f} ms per batch of {BATCH} "
            f"(median of {t['iters']}), {t['edges_per_s']:.6e} message-edges/s "
            f"({t['message_edges_per_step']} per step), host {t['host_ms']:.4f} ms to enqueue "
            f"a step; device busy {t['busy_ms']:.4f} ms, "
            f"idle share {t['idle_share']:.3f}; top kernels ms: "
            + json.dumps({k: round(v, 5) for k, v in t["top"].items()}))
    return rows, forward, train, overhead


def main() -> int:
    smi = phase_device()
    mark("[device]")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions are the reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()
    mark("[build]")

    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.data import iter_batches, plan_capacities

    records, vocab = make_bench_dataset(N_BATCHES * BATCH, seed=0)
    # headroom 2 so the 6144 records pack as exactly three full batches
    plan = plan_capacities(records, BATCH, headroom=2.0)
    batch0 = next(iter_batches(records, plan)).to(dev)
    V = vocab.bond_vocab_size + 1
    log(f"[data] {len(records)} records; cation N={batch0.cation.node_capacity} "
        f"E={batch0.cation.edge_capacity}, anion N={batch0.anion.node_capacity} "
        f"E={batch0.anion.edge_capacity}, V={V}")

    errs = phase_kernels(batch0, V, dev)
    mark("[kernels]")
    errs["fused_message_aggregate_dh"] = phase_backward(batch0, V, dev)
    mark("[backward]")
    widths, width_rows = phase_widths(batch0, records, vocab, dev)
    mark("[widths]")
    models, batch0, launches, state = phase_main_path(records, plan, vocab, dev)
    mark("[main]")
    train_steps, train_batch, train_launches = phase_train(records, plan, vocab, dev, state)
    mark("[train]")
    fit_runs, fit_launches, one_epoch_fit, fit_data = phase_fit()
    mark("[fit]")
    graphs, graphs_launches, graphs_profile = phase_graphs(records, vocab, fit_data, state)
    mark("[graphs]")
    native = phase_native(fit_data, fit_data["k1"])
    mark("[native]")
    mp, mp_launches = phase_mp(records, plan, vocab)
    mark("[mp]")
    bench = phase_bench()
    mark("[bench]")
    onehot, onehot_launches, onehot_profile = phase_onehot(
        records, plan, vocab, state, dev, fit_data)
    mark("[onehot]")
    device_ep, device_ep_launches, device_ep_profile = phase_device_epochs(
        records, vocab, state, dev, fit_data)
    mark("[device_epochs]")
    transfer, transfer_launches = phase_transfer(records, vocab, state)
    mark("[transfer]")
    screen, screen_launches, screen_profile = phase_screen(dev)
    mark("[screen]")
    # [dp]'s NCCL ranks alone; then its gloo ranks beside [ep]'s, the chain
    # of CLIs, the quality protocols and the dry run, each in processes of
    # its own (the dry run's entry() in this one): none of them is timed
    # for a comparison
    ep_calls, ep_inputs = ep_side_calls(records, plan, vocab)
    dp, dp_launches, side = phase_dp(records, plan, vocab, fit_data, {
        **ep_calls, "[chain]": phase_chain,
        "[protocols]": lambda: phase_quality(gated="--quality" in sys.argv[1:]),
        "[dryrun]": lambda: phase_dryrun(dev)})
    (chain, chain_launches), _ = side.pop("[chain]")
    (quality, quality_launches), _ = side.pop("[protocols]")
    (dryrun, dryrun_launches), _ = side.pop("[dryrun]")
    mark("[dp], with [chain], [protocols] or [quality] and [dryrun] beside its gloo ranks")
    ep, ep_launches = phase_ep(ep_inputs, side)
    mark("[ep]")
    phases, phases_launches = phase_phases(records, vocab, state, dev)
    mark("[phases]")
    demo, demo_launches = phase_demo()
    mark("[demo]")
    host_pipeline = phase_host_pipeline()
    mark("[host_pipeline]")
    bisect, bisect_launches = phase_bisect()
    mark("[bisect]")
    rows, forward, train, overhead = phase_times(
        batch0, V, models, launches, errs, train_steps, train_batch, train_launches,
        {"fit": fit_launches, "graphs": graphs_launches, "mp": mp_launches,
         "onehot": onehot_launches, "device_epochs": device_ep_launches,
         "transfer": transfer_launches, "chain": chain_launches, "screen": screen_launches,
         "dp": dp_launches, "ep": ep_launches, "quality": quality_launches,
         "phases": phases_launches, "dryrun": dryrun_launches, "demo": demo_launches,
         "bisect": bisect_launches})
    mark("[times]")
    fit_profile = fit_busy_share(one_epoch_fit)
    onehot["times"] = onehot_profile(forward["pallas_step bf16"])
    graphs = graphs_profile()
    screen["profile"] = screen_profile()
    device_ep["profile"] = device_ep_profile()
    mark("the profiler readings")

    # the widths the paths ran (the D-scaling arm, the CLI) join the kernel rows
    rows += [r for r in width_rows if r["launches"]]
    widths["times"] = width_rows
    log(json.dumps({"kernels": rows, "widths": widths,
                    "forward_ms_per_batch": forward, "train_step": train,
                    "function_overhead": overhead, "fit": fit_runs,
                    "fit_profile": fit_profile, "graphs": graphs, "native": native,
                    "mp": mp, "bench": bench, "onehot": onehot, "device_epochs": device_ep,
                    "transfer": transfer, "chain": chain, "screen": screen, "dp": dp,
                    "ep": ep, "quality": quality, "phases": phases, "dryrun": dryrun,
                    "demo": demo, "host_pipeline": host_pipeline, "bisect": bisect,
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
