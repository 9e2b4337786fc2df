#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: TF32 off, card name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``porous_cfd_tpu_torch/ops/csrc``
     (one nvcc per source, side by side) into ``build/porous_cfd_tpu_torch``;
     the (v, J, H) engine's, pointnet_global's and sa_neighborhood's
     kernels' registers, stack and spills from ``-Xptxas -v``, the engine's
     blocks per SM
     (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at the paths' widths,
     and at D = 3 (4 points, 28 rows a block) at the 3D experiments'
     launches and the 2D paths' widths, with their shared bytes,
     pointnet_global's blocks (points, shared bytes) at its five shapes and
     sa_neighborhood's (chunk width, resident or streamed weights, shared
     bytes, blocks per SM) at its four levels;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     shapes the main paths give it, timed with CUDA events, every backward
     of the engine also split into its weight gradients (``weight_grad``
     alone at each layer's stash shapes, against cuBLAS's ``a.t() @ g`` in
     full f32, timed beside it) and its rows sweep: (a) pointnet_global
     forward and backward at the pipn shape and (b) at the two pi-gano shapes
     (geometry encoder, branch), the backward's winner compaction held equal
     to ``pointnet_winner_rows`` and two backward runs bit for bit, (c) decoder_prop forward, (d) decoder_prop
     forward and backward with dropout on and off, the kept fraction of a
     full-size mask and the Philox known answers, (e) neural_ops_prop forward
     and backward with dropout on and off and the kept fraction of a full
     trunk mask, (f) sa_neighborhood forward and backward at PIPN++'s level 0
     (static) and level 1 (dynamic) shapes, and with emptied neighbourhoods,
     the argmax against the plain one, the backward's winner compaction
     held equal to ``sa_winner_rows`` and two backward runs bit for bit,
     (g) FPS at PIPN++'s two levels for all 52 cases and for one, indices
     equal to the plain version's and one launch a call, the latency floor
     (a 32-point cloud, a point a lane) and a design-B cloud (100,000 3D
     points -> 25,000, thread-block clusters),
     (h) pointnet_global and decoder_prop at PIPN++'s shapes, and
     pointnet_global at PI-GANO++'s global level, with dx, (i)
     decoder_prop's max-pool-coupled modes at the pipn shape on a real
     winner set: j0_add and ctx_width, forward and backward, dropout on and
     off, every output and gradient (dja/dha and the context block of W0
     included), (j) neural_ops_prop's other modes at pi-gano-full's shapes:
     a linear last operator and no reduction together (pi-gano-full's
     trunks), and each alone, forward and backward, dropout on and off;
     sa_neighborhood also at PI-GANO++'s two levels (32 neighbours), (k)
     PIPN++ MRG's five shapes on a real chain: sa_neighborhood at [8, 64,
     128] and [8, 64, 128, 256] (static) and [130, 256] (dynamic, one
     layer), pointnet_global at [8, 128, 256, 512] over 1000 rows and [258,
     512] (one layer) over 63 + 500, (m) the manufactured PIPN++'s shapes,
     all at tanh, on a real chain of make_manufactured_batch cases of
     1000 / 200 points: sa_neighborhood at [6, 64] (static, one layer) and
     [66, 128] (dynamic, one layer), FPS 200 -> 100 -> 25 over 52 cases'
     and one case's boundary clouds, pointnet_global one layer [130, 1024]
     over 25 centroids, the decoupled decoder [1088, 512, 256, 128, 3]
     without dropout, with blocks per SM; and pointnet_global's backward at
     the four ++ global levels timed in turns (PN_PP_LEVELS); (n) the
     U-Nets' shapes on a real all-points chain: FPS 2500 -> 1250 (design B,
     thread-block clusters) -> 313 over all 52 clouds, sa_neighborhood at
     [9, 64, 64, 128] (1250 centroids) and [130, 128, 128, 256] (313), both
     dynamic, 64 neighbours, pointnet_global one layer [258, 1024] and
     [258, 512] over 313 rows with dx, and PI-GANO++ full's branch [8, 128,
     256, 256, 256]; (o) after phase 29 writes the 3D data, the 3D
     experiments' shapes: the engine at D = 3 (abc's decoders [1088, 512,
     256, 128, 4] and [1088, 384, 128, 4], windbreaks' trunk of four 512-wide
     operators on 256 local columns reduced to 4, and the 512 decoder and
     352 trunk of the 2D paths at D = 3, each timed beside its D = 2 row),
     forward and backward, dropout on and off, each backward split into its
     rows sweep and its weight gradients at the D = 3 stash rows, beside
     cuBLAS; sa_neighborhood on real 3D
     chains of abc's solved cases and windbreaks' synthetic split at 1500 /
     1000 / 700 points: abc pipn-pp's [10, 64, 128] and [131, 128, 256] at
     16 neighbours, windbreaks pi-gano-pp's [11, 64, 128] and [131, 128] at
     64, both U-Nets' all-points levels; FPS over 3D boundary clouds (design
     A) and all points (design B); pointnet_global at every 3D global level,
     geometry encoder and branch;
  4. pipn prediction: verbose prediction (fields + PDE residuals) of 52
     synthetic cases at 1500/1000/700 internal/boundary/observation points, in
     4 batches of 13, through the full-width duct_fixed_boundary ``pipn``
     model; launch counts, finiteness, and one batch against the same module
     on the CPU; the time per batch is the median of 7 runs of the 52 cases;
  5. pipn training: the same model and cases, Adam with the duct example's
     fixed loss weights, batch 13 (4 steps an epoch): launch counts per step,
     finite non-zero gradients, the loss falling, one step on 2 cases
     against the CPU with dropout on, a Trainer.fit with checkpoints, and
     steps/s over whole epochs (the median of TRAIN_RUNS runs of 10 epochs);
  6. pi-gano prediction: phase 4 for the full-width duct_variable_boundary
     ``pi-gano`` model on the same cases (its geometry and branch inputs
     attached once per dataset);
  7. pi-gano training: phase 5 for that model, with the example's fixed loss
     weights;
 6b, 7b. pi-gano-full prediction and training: phases 4 and 5 for the
     example's ``pi-gano-full`` (three trunks without reduction, six
     neural_ops_prop launches each way);
 6c, 7c. pi-gano-pp prediction and training: the card's boundary chain
     against the CPU's and the time of attach_neighbors of 13 cases with
     FPS's share of it, then phases 4 and 5 for the example's
     ``pi-gano-pp`` (two SA levels at 32 neighbours, a global level);
  8. pipn_pp prediction: phase 4 for the full-width duct_fixed_boundary
     ``pipn-pp`` model (its boundary cloud's SetAbstraction chain attached
     once per dataset, FPS on the card), with the card's chain against the
     CPU's, the mean valid neighbours per level and attach_neighbors' time
     as in 6c;
  9. pipn_pp training: phase 5 for that model;
 10. pipn_coupled prediction: phase 4 for ``pipn`` with
     ``coupled_context=True`` (winner gather, decoder_prop's j0_add mode),
     after coupled and decoupled values are held equal and their J/H equal
     off the pooling winners' rows; the card-vs-CPU rows leave out those of
     a channel whose winner differs between the two (a near-tie);
 11. pipn_coupled training: phase 5 for it, the card-vs-CPU step on the
     first two cases whose winners agree;
 12. pipn_exact prediction: phase 4 for ``pipn`` with
     ``fast_derivatives=False`` (the exact autodiff operator, no kernel:
     every launch count stays 0), against the CPU on 2 cases, after its J
     is held to the coupled path's off the winner rows;
 13. pipn_exact training: phase 5 for it, over EXACT_RUNS runs of 3 epochs;
 14. manufactured: the verification recipe, ``pipn_manufactured`` with
     ``fast_derivatives=True`` (the coupled path, tanh) on
     ``make_manufactured_batch(rng(8421), 16, 400, 120)``, 101 epochs of 4
     steps, the loss at epochs 0/25/50/75/100 falling; then a few steps of
     its default exact path;
 15. the CLI: the port's case writer makes a 13 / 4 case variable split,
     and ``python -m porous_cfd_tpu_torch.examples.duct_variable_boundary
     .train --model pi-gano-full`` (in a subprocess; then ``pi-gano-pp-full``
     in process) trains it for 30 epochs at its default bf16-mixed precision: checkpoints, model_meta.json, the
     training loss falling by CLI_MIN_FALL of itself at least, ms per epoch
     over the whole fit and after its first chunk of 10 epochs; the
     variable duct's inference CLI restores the first checkpoint and
     predicts as its weights do within RTOL, and its evaluate CLI prints
     finite numbers;
 16, 17. pipn_pp_mrg prediction and training: phases 8 and 9 for the
     full-width duct_fixed_boundary ``pipn-pp-mrg`` model (three radius
     levels and two global ones on one boundary chain: 3 sa_neighborhood, 2
     pointnet_global and 2 decoder_prop launches each way a step);
 18. the duct_fixed_boundary CLIs: the port's FVM solver writes FIX_TRAIN +
     FIX_VAL golden-duct cases at the golden grid; the training CLI trains
     ``pipn`` (decoupled), ``pipn-pp-mrg`` and ``pipn-pp-full`` (the U-Net)
     for FIX_EPOCHS epochs at the
     golden points, the loss without dropout falling by FIX_MIN_FALL of
     itself at least; the inference CLI restores each checkpoint and
     predicts as the trained model does within RTOL; the evaluate CLI
     prints finite errors and pressure drops;
 19. the bench: ``python -m porous_cfd_tpu_torch.bench`` with BENCH_RUNS
     runs of BENCH_EPOCHS epochs; its line parses, with steps/s for all ten
     families, the two U-Nets among them;
 20, 21. pipn_pp_manufactured prediction and training: phases 8 and 9 for
     the full-width manufactured_solutions ``pipn-pp`` model on 52 cases of
     make_manufactured_batch(rng(8421), 52, 1000, 200), its six physics
     losses weighted 1 (2 sa_neighborhood, 1 pointnet_global and 2
     decoder_prop launches each way a step, FPS twice an attach);
 22. the manufactured_solutions CLIs: ``generate_data`` writes its 16 / 4 /
     4 split; the training CLI trains ``pipn-pp`` (the four kernels) and
     ``pipn`` (the exact operator, no launch) for MS_CLI_EPOCHS epochs; the
     loss without dropout falls; inference restores each checkpoint and
     predicts as the trained model does within RTOL; evaluate prints finite
     errors;
 23. the exact paths (``fast_derivatives=False``) of pipn-pp, pipn-pp-mrg,
     pi-gano and pi-gano-pp at full width: values, J and H equal to the
     analytic path's within RTOL for one seed, dropout on, over BATCH cases;
     EXACT_STEPS training steps launching no kernel, the loss without
     dropout falling;
 24, 25. pipn_pp_full prediction and training: the card's all-points chain
     and FP kNN indices against the CPU's (equal but at near-ties,
     FP_TIE), then phases 8 and 9 for the full-width duct_fixed_boundary
     ``pipn-pp-full`` (the U-Net on its decoupled-hierarchy analytic path: 2
     sa_neighborhood and 1 pointnet_global launches each way a step, FPS
     twice an attach), the card against the CPU on 2 cases, H within
     UNET_H_RTOL;
 26, 27. pi_gano_pp_full prediction and training: the same for the
     duct_variable_boundary ``pi-gano-pp-full`` (2 pointnet_global each way,
     its branch included);
 28. the U-Nets' exact paths (micro-batches of 2) over EXACT_CASES cases:
     values against the analytic path, the analytic path's J and H against
     autodiff of the frozen hierarchy, the peak device memory and time of
     one step as built, with the JAX modules' k_chunks running max in the
     SA levels (gradients equal) and in micro-batches of 1, then
     UNET_EXACT_STEPS steps launching no kernel, the loss falling;
 29. the batched 3D solver (``datagen/fvm3d_batch.py``): the JAX test's two
     cases at 20 x 12 x 12 against the port's numpy solver at the JAX
     test's agreement; then abc's D3_TRAIN zoo cases and the 3D golden
     run's 3 held-out cases marched at 48 x 28 x 28 and written as the
     golden run writes them: ms a step, the steps to converge; windbreaks'
     synthetic 5-patch split written beside them;
 30-35. abc ``pipn`` (decoupled) and ``pipn-pp``, on the solver's cases,
     and windbreaks ``pi-gano`` and ``pi-gano-pp`` on the synthetic split,
     built at full width by the CLIs' get_model (D = 3): phases 4 and 5 for
     each (the ++ models' chains card against CPU first), with the
     examples' 12 loss weights;
 36. the 3D CLIs: abc's ``pipn``, ``pipn-pp`` and ``pipn-pp-full`` and
     windbreaks' ``pi-gano``, ``pi-gano-pp`` and ``pi-gano-pp-full`` train
     D3_CLI_EPOCHS epochs (abc's first through ``python -m`` in a
     subprocess, the others in process with their launch counts),
     the loss without dropout falling; the inference CLI restores each
     checkpoint and predicts as its weights do within RTOL; the evaluate
     CLI prints finite numbers (the MAE by inlet speed; the house's surface
     errors and the MAE by (d, inlet speed));
 37. the batched 2D solver (``datagen/fvm_batch.py``): the JAX test's three
     cases at 40 x 24 against the port's numpy solver at the JAX test's
     agreement; then one march of GRID_CHUNK cases of the 621-case
     transform grid at 120 x 72 (the grid tool's chunk, tolerance and step
     limit): its wall, ms a step and the largest and median step counts;
     the step replayed as a CUDA graph against its eager launches (fields,
     steps, ms a step);
 38. the duct_fixed_boundary_hard and vertical_duct_fixed_boundary CLIs on
     phase 18's golden cases and pipn checkpoint: the hard CLI trains pipn
     with its loss weights (launch counts, the loss without dropout
     falling by FIX_MIN_FALL), restores within RTOL and evaluates; the
     vertical CLI fine-tunes phase 18's checkpoint VERT_EPOCHS epochs on a
     written two-inlet (inlet-top) split, resuming at its epoch, the loss
     falling from the checkpoint's, restores and evaluates;
 39. a small transform grid: GRID_SMALL cases of the fixed grid's split
     written by ``tools/golden_transform_grid.py`` with the batched solver,
     ``tools/train_golden_grid.py`` (pipn coupled, GRID_EPOCHS epochs,
     scored on the three splits, the test split evaluated),
     ``tools/analyze_grid_errors.py`` and ``tools/analyze_p_offset.py``:
     launch counts of the coupled path, every number finite;
 40. the evaluation's output layer: the duct_fixed_boundary compare CLI on
     phase 18's held-out cases, ``pipn`` against ``pipn-pp-mrg``, through
     ``python -m`` (``Test.csv``, ``Shapiro.csv``, p-values in [0, 1]) and
     in process (pointnet_global, decoder_prop, sa_neighborhood and FPS
     forward launches, no backward), its two error arrays within RTOL and
     its rank tests' p-values, and its log-error tests' over the errors
     above the card's noise floor (COMPARE_LOG_FLOOR), within
     COMPARE_P_RTOL of the same compare on the CPU; the
     duct_variable_boundary compare CLI on phase 15's split, ``pi-gano-full``
     against ``pi-gano-pp-full`` (neural_ops_prop too); the fixed evaluate
     CLI's error table, finite, with the CPU's row labels; ``--save-plots``
     refused with the ImportError that names matplotlib and no launch when
     the card's machine has none, else the JAX file names written. Phases 15
     and 18 keep their splits and checkpoints for it.
 41. multi-device training on the one card: two ranks on cuda:0 (gloo, the
     backend that takes two ranks a device) step the full-width ``pipn``
     (decoupled, dropout on) on MR_CASES cases, once split over the data
     axis (2 x 1: shares 7 / 6) and once over the points axis (1 x 2), each
     rank's step counted and held to one process's step on the card
     (metrics, gradients and updated parameters within RTOL); then the
     duct_fixed_boundary training CLI at ``--mesh-data 1`` (a process group
     of one under NCCL) on a written synthetic split; the mesh's
     collectives on CUDA tensors through gloo (all_reduce sum / max / min,
     all_gather) on the two ranks; and ``min_distance`` on the card, alone
     and split over the two ranks, against the CPU's float64. Then every
     other family and derivative path (MR_PATHS: ``pipn`` coupled and
     exact, PIPN++ on both paths, MRG, both U-Nets and the exact U-Net in
     micro-batches, ``pi-gano`` exact and analytic, -full, -pp, the
     manufactured PIPN exact and coupled and PIPN++, abc ``pipn-pp`` and
     windbreaks ``pi-gano`` at D = 3), each at its own phase's full width
     and batch, one counted step with its rows split over the two ranks
     (1 x 2), held to one process's step on the card: each rank's launches,
     the rows of its (v, J, H) calls (the share's), its metrics, gradients
     and updated parameters, its ms a step and peak memory.
 42. the measurement tools (``porous_cfd_tpu_torch/tools/``) in process at
     the full-width bench envelope, few repetitions: ``profile_step
     --family pipn``, ``profile_pp`` (pipn_pp), ``roofline --families
     pipn,pipn_pp`` (with the two profiles' steps/s as its measured rates),
     ``mfu --families pipn,pi_gano``, ``profile_gano``, ``profile_delta``
     for pipn, pipn_pp and pi_gano, ``measure_full_rates --steps 2``,
     ``torch_baseline --steps 2``, ``samehost_ratio --torch-steps 2`` (its
     baseline in a subprocess of its own), ``make_mesh_assets`` into a
     temporary directory and ``render_smoke``. Each tool's printed line
     parses, every number in it finite and positive, its card label
     ``nvidia-smi``'s; each profile tool launched its family's kernels;
     each piece's device ms is at most its CUDA-event wall ms plus 5%;
     every MFU lies in (0, 1] and every percentage of a peak in (0, 100];
     roofline's pipn decoder forward FLOPs equal, within 0.5%, what phase 3
     counts for the same decoder_prop launch; the eleven OBJ files equal
     the checked-in ones; render_smoke exits 0 with its two SKIP lines
     (neither PyVista nor bpy is installed on the card's machine).
Each of phases 4-14, 16-17, 20-21, 24-27 and 30-35 sets every launch count to 0 just
before it and reads them just after (phases 18, 22 and 36 around each
in-process training command, 38 and 39 around each training command,
23 and 28 around their steps, 40 around each in-process compare, 41 in
each rank around its step and around the CLI, 42 around each tool); every
training phase also counts the synchronizing calls of one step, which must
be none. Each phase logs the second it starts at (``[clock]`` lines). The
second-to-last lines are the
``{"kernels": [...]}`` JSON and the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Each kernel's ``bound_ms`` is the
least time of its work at f32 accuracy: the larger of its operations in
3xTF32 on the tensor cores (three TF32 products) and its bytes over HBM
bandwidth; ``bound_f32_core_ms`` keeps the f32 CUDA-core bound beside it.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the duct_fixed_boundary "pipn" configuration at full width
NU, D, F = 1489.4e-6, 14000.0, 17.11
N_BID = 4
FE_LOCAL = [2, 64, 64]
FE_GLOBAL = [64 + 1 + N_BID, 96, 128, 1024]
SEG = [1024 + 64, 512, 256, 128, 3]
SEG_DROPOUT = [0.05, 0.05, 0, 0]
# the duct_variable_boundary "pi-gano" configuration at full width
# (examples/duct_variable_boundary/train.py, bench.py's "pi_gano")
PG_BRANCH = [8, 128, 352, 352, 352]
PG_GEOMETRY = [2 + N_BID + 1, 64, 176, 176, 176]
PG_LOCAL = [2, 64, 176, 176, 176]
PG_OPERATORS, PG_DROPOUT = 4, [0, 0.1, 0.1, 0]
# the duct_fixed_boundary "pipn-pp" configuration at full width
# (examples/duct_fixed_boundary/train.py:49-61, bench.py's "pipn_pp"); the
# last conv stack has no radius, a trailing GlobalSetAbstraction
PP_LOCAL = [2, 64, 64]
PP_RADIUS, PP_FRACTION, PP_NEIGHBORS = [0.5, 1], [0.5, 0.25], 64
PP_GLOBAL = [[2 + N_BID + 2, 64, 64], [64 + 2, 128, 128], [128 + 2, 256, 1024]]
PP_SEG = [1024 + 64, 378, 128, 3]
PP_DROPOUT = [0.05, 0, 0]
BATCH, N_INT, N_BND, N_OBS, N_CASES = 13, 1500, 1000, 700, 52
# FPS beyond the paths: the latency floor's 32-point cloud (a point a lane),
# timed to FLOOR_N and to FLOOR_PICKS picks, and a design-B cloud (points,
# dims, picks) past one block's capacity
FLOOR_N, FLOOR_PICKS = 32, 2048
FPS_BIG = (100_000, 3, 25_000)
PG_N_BRANCH = N_BND // 4 + N_INT        # branch rows: the inlet patch + internal
SEED = 8421
SLICE_RUNS = 7
# both examples' fixed loss weights: continuity, momentum x/y, boundary u x/y
# and p, observations u x/y and p
LOSS_WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# timed runs of each training phase: 2 (and 1 on the exact path); these,
# D3_CLI_EPOCHS, EXACT_STEPS, UNET_K_CHUNKS and the CLIs run in process (a
# subprocess costs about 20 s of start-up on the card's machine) keep the
# script inside its 1200 s on a host 1.3 times slower than the fastest seen
TRAIN_RUNS, TRAIN_EPOCHS = 2, 10
EXACT_RUNS, EXACT_EPOCHS = 1, 3
# the manufactured-solutions recipe: 16 cases of 400/120 points, batch 4
MS_CASES, MS_INT, MS_BND, MS_BATCH, MS_EPOCHS = 16, 400, 120, 4, 101
MS_FE_GLOBAL = [64 + 2 + 1, 64, 128, 1024]
# the duct_variable_boundary "pi-gano-pp" configuration at full width
# (examples/duct_variable_boundary/train.py:56-69): two radius levels over
# the boundary cloud's [C || boundaryId] rows and a global one, 32 neighbours
PGP_GEOMETRY = [[2 * 2 + N_BID, 64, 64], [64 + 2, 176, 176], [176 + 2, 176, 176]]
PGP_RADIUS, PGP_FRACTION, PGP_NEIGHBORS = [0.5, 1], [0.5, 0.25], 32
# the duct_fixed_boundary "pipn-pp-mrg" configuration at full width
# (examples/duct_fixed_boundary/train.py:62-70): the MRG encoder's own widths
# over the boundary cloud's [boundaryId || C] rows, 64 neighbours
MRG_LOCAL, MRG_IN = [2, 64, 64], N_BID + 2
MRG_SEG = [1024 + 64, 384, 128, 3]
MRG_DROPOUT = [0.05, 0, 0]
# MRG's five kernel shapes: (level, widths)
MRG_SA = (("branch1_sa0", [MRG_IN + 2, 64, 128]), ("branch2_sa", [MRG_IN + 2, 64, 128, 256]),
          ("branch1_sa1", [128 + 2, 256]))
MRG_GLOBAL = (("branch3_gsa", [MRG_IN + 2, 128, 256, 512]), ("branch4_gsa", [256 + 2, 512]))
# the fixed-boundary CLI phase: golden cases solved by the port's FVM solver
# at the golden grid and written with their meta, the golden run's points
# (the grid exposes 2 * (120 + 72) boundary faces), FIX_EPOCHS epochs of the
# training CLI for each model; FIX_TRAIN + FIX_VAL cases, not the golden
# run's 13 + 4, since each costs seconds of host time to solve
FIX_GRID, FIX_TRAIN, FIX_VAL, FIX_EPOCHS = (120, 72), 4, 2, 30
FIX_POINTS = (1500, 350, 700)
# the least relative fall of the fixed-boundary CLI's training loss
# (without dropout) over its FIX_EPOCHS steps from the seeded weights
FIX_MIN_FALL = 1e-2
FIX_MODELS = ("pipn", "pipn-pp-mrg", "pipn-pp-full")
# phase 40: the compare CLI's p-values on the card against the CPU's, each
# pair within COMPARE_P_RTOL of the larger, or within COMPARE_P_ATOL. The
# errors differ between 3xTF32 and f32 in their last bits (about 1e-6 of
# their largest). The rank tests (Kruskal-Wallis, Mann-Whitney U) see that
# only through a few swapped ranks, and the compare's own p-values are held.
# The tests over the errors' logs (ANOVA, Shapiro, Levene) see it amplified
# where an error is itself near that noise: an error e that moves by d moves
# its log by d / e. They are held over the errors above COMPARE_LOG_FLOOR
# times the largest card-against-CPU difference of their field's errors,
# whose logs the card moves by at most 1 / COMPARE_LOG_FLOOR; their gaps over
# all errors, and over those above COMPARE_SMALL of the field's largest, are
# printed beside them, with the number of errors each leaves out. A p-value
# far below any test's level moves by more, relative to itself, for the same
# change of its statistic, hence COMPARE_P_ATOL
COMPARE_P_RTOL, COMPARE_P_ATOL = 1e-3, 1e-6
COMPARE_LOG_FLOOR, COMPARE_SMALL = 1e3, 1e-5
# the manufactured_solutions "pipn-pp" configuration at full width
# (examples/manufactured_solutions/train.py): one-layer static and dynamic
# radius levels over the boundary cloud's [boundaryId || C] rows, a
# one-layer 1024-wide global level and the decoupled decoder, all at tanh,
# on cases of 1000 internal and 200 boundary points; physics-only, so six
# losses (continuity, momentum x/y, boundary u x/y and p), each weighted 1
MSP_LOCAL = [2, 64, 64]
MSP_GLOBAL = [[2 * 2 + 2, 64], [64 + 2, 128], [128 + 2, 1024]]
MSP_RADIUS, MSP_FRACTION, MSP_NEIGHBORS = [0.6, 1.2], [0.5, 0.25], 64
MSP_SEG = [1024 + 64, 512, 256, 128, 3]
MSP_INT, MSP_BND = 1000, 200
MSP_WEIGHTS = (1,) * 6
# pointnet_global's backward at the ++ global levels, timed in turns:
# (label, widths, rows a case); MRG's one-layer branch-4 level pools its two
# branches' centroids (63 + 500)
PN_TURNS = 3
PN_PP_LEVELS = (("pipn_pp", PP_GLOBAL[-1], 125), ("pi-gano-pp", PGP_GEOMETRY[-1], 125),
                ("pipn_pp_mrg branch4", [256 + 2, 512], 563),
                ("pipn_pp manufactured", MSP_GLOBAL[-1], 25))
# the manufactured CLI phase: generate_data's 16 / 4 / 4 split (200 internal
# and 40 + 40 boundary points a case), MS_CLI_EPOCHS epochs of each zoo model
# at batch MS_CLI_BATCH
MS_CLI_EPOCHS, MS_CLI_BATCH = 30, 8
MS_CLI_POINTS = (200, 80)
# the exact-path phase: EXACT_STEPS training steps with dropout on over
# EXACT_CASES cases for each family (pipn-pp-mrg's loss first rises, for
# about 15 steps from the seeded weights, before it falls)
EXACT_STEPS, EXACT_CASES = 30, 4
# the duct examples' U-Nets at full width are built by the CLIs' own
# get_model ("pipn-pp-full", "pi-gano-pp-full"): a SetAbstraction encoder
# over all points, dynamic from level 0 on (its rows [sdf || boundaryId ||
# C]), ending in a one-layer global level; a FeaturePropagation decoder
# The U-Nets' H: the JAX package's own U-Net tolerance
# (tests/test_fp_analytic.py:205-207), of the largest entry. A point near a
# coarse point has an interpolation weight w = 1 / d^2 of 1e4 and more, and
# H's w^3 terms amplify rounding (the SA kernels' 3xTF32 against cuBLAS's
# or the CPU's f32) by as much; the tests hold the same H to float64.
UNET_H_RTOL = 5e-3
# The U-Nets' encoder gradients of one training step, card against CPU: a
# channel whose top two neighbour rows lie within the kernels' 3xTF32
# rounding of each other pools another row on the card than on the CPU,
# and its gradient lands on that row's inputs; over the all-points levels'
# 2 x 1250 x 128 channels of 2 cases that moved level 0's first weight by
# 1.6e-4 of its largest gradient on an H100
UNET_POOLED_RTOL = 2e-3
# the U-Nets' exact-path phase: UNET_EXACT_STEPS training steps over
# EXACT_CASES cases, micro-batches of 2 (3-5 s a step on an H100), and the
# chunk count of the JAX modules' k_chunks running max it compares with
UNET_EXACT_STEPS, UNET_K_CHUNKS = 3, 4
# the parameters of the max-pooled encoders (SetAbstraction and global
# levels, PI-GANO's geometry encoder and branch): a channel whose top two
# rows lie within rounding of each other may pool a different winner on
# the exact path (plain PyTorch, cuBLAS f32) than on the analytic path (the
# kernels, 3xTF32), and its gradient then lands on another row
POOLED_PARAMS = ("feature_extract.global_feature.", "global_fe.", "geometry_encoder.",
                 "branch.")
# the bench phase: its line at the envelope, fewer runs and epochs than its
# defaults (5 of 10), which the standalone bench keeps
BENCH_RUNS, BENCH_EPOCHS = 1, 2
# the CLI phase: a variable split written by the port, cases of
# CLI_CASE_POINTS internal points and four patches of CLI_PATCH_POINTS
CLI_TRAIN, CLI_VAL, CLI_EPOCHS = 13, 4, 30
CLI_MODELS = ("pi-gano-full", "pi-gano-pp-full")
CLI_CASE_POINTS, CLI_PATCH_POINTS = 3000, 300
# the least relative fall of the CLI's training loss (without dropout) over
# its CLI_EPOCHS steps: this loss falls slowly from the seeded weights, by
# about 6e-4 of itself over 30 steps on an H100; a third of that is asked
CLI_MIN_FALL = 2e-4
# The 3D experiments, built at full width by the port's CLIs' own
# get_model: abc (examples/abc/train.py: the PIPN family, 4 boundary ids,
# 16 neighbours on the ++ models) and windbreaks (examples/windbreaks/
# train.py: the PI-GANO family, 5 boundary ids and a solid house patch, the
# inlet's Ux a branch feature). abc's cases: D3_TRAIN random zoo cases
# (tools/train_golden_3d.zoo_cases) and the golden run's 3 held out,
# solved by the batched solver on the card at the golden grid and written
# as the golden run writes them (4,000 internal points, 500 a patch);
# windbreaks': a synthetic 5-patch split of as many cases (no solved
# windbreaks data exists in the repository)
D3_TRAIN, D3_GRID = 26, (48, 28, 28)
WB_CASE_POINTS, WB_PATCH_POINTS, WB_VAL = 2000, 250, 3
WB_PATCHES = ["inlet", "interface", "outlet", "solid", "walls"]
# the examples' fixed loss weights over their 12 losses (continuity,
# momentum x/y/z, boundary u x/y/z and p, observations u x/y/z and p)
ABC_WEIGHTS = (1,) * 8 + (100,) * 4
WB_WEIGHTS = (10,) * 4 + (1,) * 8
# the batched solver against the numpy one: the JAX test's grid, cases,
# tolerance and agreement (tests/test_fvm3d_tpu.py:9-40)
SOLVER_GRID, SOLVER_TOL, SOLVER_STEPS = (20, 12, 12), 5e-4, 6000
SOLVER_CASES = [("band", (0.1, 0.0, 0.0), 0.10, 0.20),
                ("sphere", (0.12, 0.02, -0.02), 0.12, 0.16)]
# the 3D CLIs: D3_CLI_EPOCHS epochs of each model over the 3D splits at the
# envelope's points (more than the CLIs' first chunk of --log-every 10 epochs: the phase reads
# the fit's time after it)
D3_CLI_EPOCHS = 12
# the 3D experiment whose first CLI runs through ``python -m`` in a
# subprocess (about 20 s of start-up on the card's machine); every other
# 3D CLI runs in process
D3_CLI_SUBPROCESS = "abc"
ABC_CLI_MODELS = ("pipn", "pipn-pp", "pipn-pp-full")
WB_CLI_MODELS = ("pi-gano", "pi-gano-pp", "pi-gano-pp-full")
# the batched 2D solver against the numpy one: the JAX test's grid, cases
# (an anisotropic Darcy pair, a per-case f and an angled inlet among them),
# tolerance and agreement (tests/test_fvm_tpu.py:11-50)
SOLVER2_GRID, SOLVER2_TOL, SOLVER2_STEPS = (40, 24), 5e-4, 8000
SOLVER2_CASES = [
    dict(shape="circle", cx=0.10, cy=0.00, size=0.12, theta=0.0),
    dict(shape="square", cx=0.08, cy=0.02, size=0.12, theta=math.radians(30), sx=0.875,
         sy=0.75),
    dict(shape="ellipse", cx=0.12, cy=-0.02, size=0.13, theta=math.radians(70),
         d=(12000.0, 20000.0), f=30.80, u_inlet=0.15 * math.cos(math.radians(20)),
         v_inlet=0.15 * math.sin(math.radians(20)))]
# the reference-scale grids: one march of GRID_CHUNK cases (the grid tool's
# chunk) at the golden grid GRID_2D, the tool's step limit
GRID_2D, GRID_CHUNK, GRID_MAX_STEPS = (120, 72), 160, 30000
# steps of the same chunk launched eagerly, for the graph's gain
GRID_EAGER_STEPS = 1000
# the vertical CLI: a written two-inlet split of FIX_TRAIN + FIX_VAL cases
# of VERT_POINTS internal points and VERT_PATCH_POINTS a patch, fine-tuned
# VERT_EPOCHS epochs from phase 18's pipn checkpoint
VERT_PATCHES = ["inlet", "inlet-top", "interface", "outlet", "walls"]
VERT_POINTS, VERT_PATCH_POINTS, VERT_EPOCHS = 2000, 100, 20
# the small grid run: (train, val, test) cases of the fixed grid's split,
# GRID_EPOCHS epochs of the north-star recipe
GRID_SMALL, GRID_EPOCHS = (14, 5, 5), 20

# a kNN near-tie: two expansion-form squared distances |q|^2 - 2 q.s + |s|^2
# within a few f32 ulps of their largest term (up to 2 on the [-1, 1]
# square), which the card's and the CPU's rounding may order either way
FP_TIE = 2e-6

# Tolerance of every comparison on the card: |a - b| <= RTOL * max|ref|.
# The kernels, cuBLAS and the CPU's BLAS sum the 352- to 1024-wide rows in
# different orders (all in f32; the engine's and pointnet's products in
# 3xTF32, within about 2^-21 of each f32 product), and the backward kernels
# add row chunks in another order, so errors scale with the largest
# magnitude.
RTOL = 1e-4

# published H100 peaks (NVIDIA data sheets), by product name: f32 outside the
# tensor cores, HBM bandwidth, and the dense TF32 tensor-core rate (half the
# sheets' sparse figure). f32-accurate work on the tensor cores (3xTF32)
# takes three TF32 products, so it runs at a third of that rate.
PEAKS = {"PCIe": (51.2e12, 2.0e12, 378.0e12), "NVL": (60.0e12, 3.9e12, 417.5e12),
         "": (67.0e12, 3.35e12, 494.7e12)}

REPLACES = {
    "pointnet_global": "porous_cfd_tpu/ops/pointnet_pallas.py:37 (_fwd_kernel; "
                       "pallas_call at :125)",
    "pointnet_global_bwd": "porous_cfd_tpu/ops/pointnet_pallas.py:70 (_bwd_kernel; "
                           "pallas_call at :146)",
    "decoder_prop": "porous_cfd_tpu/ops/decoder_pallas.py:168 (_fwd_kernel; "
                    "pallas_call at :433), decoupled mode, with dropout",
    "decoder_prop_bwd": "porous_cfd_tpu/ops/decoder_pallas.py:228 (_bwd_kernel; "
                        "pallas_call at :473), decoupled mode, with dropout",
    "decoder_prop_j0_add": "porous_cfd_tpu/ops/decoder_pallas.py:168 (_fwd_kernel; "
                           "pallas_call at :433), j0_add mode (:153-156, :199-201, "
                           ":597-611)",
    "decoder_prop_j0_add_bwd": "porous_cfd_tpu/ops/decoder_pallas.py:228 (_bwd_kernel; "
                               "pallas_call at :473), j0_add mode (:283-285, :355-357)",
    "decoder_prop_ctx": "porous_cfd_tpu/ops/decoder_pallas.py:168 (_fwd_kernel; "
                        "pallas_call at :433), ctx_width mode (:134-139, :195, :381-386, "
                        ":590-592)",
    "decoder_prop_ctx_bwd": "porous_cfd_tpu/ops/decoder_pallas.py:228 (_bwd_kernel; "
                            "pallas_call at :473), ctx_width mode (:276, :334-344, :622)",
    "neural_ops_prop": "porous_cfd_tpu/ops/neural_op_pallas.py:107 (_fwd_kernel; "
                       "pallas_call at :357), with dropout",
    "neural_ops_prop_bwd": "porous_cfd_tpu/ops/neural_op_pallas.py:154 (_bwd_kernel; "
                           "pallas_call at :391), with dropout",
    "neural_ops_prop_full": "porous_cfd_tpu/ops/neural_op_pallas.py:107 (_fwd_kernel; "
                            "pallas_call at :357), last_activation=False and "
                            "out_features=None together (:64, :74-75, :86-87, :125-134, "
                            ":143-147), with dropout",
    "neural_ops_prop_full_bwd": "porous_cfd_tpu/ops/neural_op_pallas.py:154 (_bwd_kernel; "
                                "pallas_call at :391), last_activation=False and "
                                "out_features=None together (:168, :200, :224), with dropout",
    "neural_ops_prop_linear_last": "porous_cfd_tpu/ops/neural_op_pallas.py:107 (_fwd_kernel; "
                                   "pallas_call at :357), last_activation=False alone "
                                   "(:74-75, :125-134), with dropout",
    "neural_ops_prop_linear_last_bwd": "porous_cfd_tpu/ops/neural_op_pallas.py:154 "
                                       "(_bwd_kernel; pallas_call at :391), "
                                       "last_activation=False alone (:200, :242, :271)",
    "neural_ops_prop_no_reduction": "porous_cfd_tpu/ops/neural_op_pallas.py:107 (_fwd_kernel; "
                                    "pallas_call at :357), out_features=None alone (:64, "
                                    ":86-87, :98-99, :143-147), with dropout",
    "neural_ops_prop_no_reduction_bwd": "porous_cfd_tpu/ops/neural_op_pallas.py:154 "
                                        "(_bwd_kernel; pallas_call at :391), "
                                        "out_features=None alone (:168, :224)",
    "sa_neighborhood": "porous_cfd_tpu/ops/sa_pallas.py:67 (_fwd_kernel; pallas_call at "
                       ":284 through _build_static, the static variant, and at :215 through "
                       "_build, the dynamic one)",
    "sa_neighborhood_bwd": "porous_cfd_tpu/ops/sa_pallas.py:107 (_bwd_kernel; pallas_call "
                           "at :304, static, and :235, dynamic)",
    "farthest_point_sampling": "porous_cfd_tpu/ops/fps_pallas.py:26 (_fps_kernel; "
                               "pallas_call at :76)",
}
SOURCES = {"pointnet_global": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "pointnet_global_bwd": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "decoder_prop": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_bwd": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_j0_add": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_j0_add_bwd": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_ctx": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_ctx_bwd": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "neural_ops_prop": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_bwd": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_full": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_full_bwd": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_linear_last": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_linear_last_bwd": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_no_reduction": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_no_reduction_bwd": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "sa_neighborhood": "porous_cfd_tpu_torch/ops/csrc/sa_neighborhood.cu",
           "sa_neighborhood_bwd": "porous_cfd_tpu_torch/ops/csrc/sa_neighborhood.cu",
           "farthest_point_sampling": "porous_cfd_tpu_torch/ops/csrc/fps.cu"}


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key and key in name:
            return val
    return PEAKS[""]


def time_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_times(torch, fn, runs=10):
    """Device ms per call of each kernel ``fn`` launches, under
    torch.profiler, largest first, and their sum: free of the host's time
    between launches, which CUDA events around back-to-back calls of a
    short kernel measure instead."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and e.count:
            rows.append({"ms": us / runs / 1e3, "count": e.count // runs, "name": e.key[:90]})
    rows.sort(key=lambda r: -r["ms"])
    return {"device_ms": sum(r["ms"] for r in rows), "kernels": rows}


def max_err(a, ref, rtol=RTOL):
    """(max |a - ref|, allowed) for one tensor pair."""
    err = (a.double() - ref.double()).abs().max().item()
    return err, rtol * max(ref.double().abs().max().item(), 1e-30)


def check_close(name, pairs, quiet=False, rtol=None):
    """Each (label, a, ref) of ``pairs`` within RTOL * max|ref|; ``rtol``
    maps a label to another tolerance."""
    worst = 0.0
    for label, a, ref in pairs:
        if tuple(a.shape) != tuple(ref.shape):
            fail(f"{name} {label}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
        if not bool(a.isfinite().all()):
            fail(f"{name} {label}: non-finite values")
        err, allowed = max_err(a, ref, (rtol or {}).get(label, RTOL))
        if not quiet:
            log(f"  {name} {label}: max|err| {err:.3e} (allowed {allowed:.3e})")
        if err > allowed:
            fail(f"{name} {label}: max|err| {err:.3e} > {allowed:.3e}")
        worst = max(worst, err)
    if quiet:
        log(f"  {name}: {len(pairs)} tensors, worst max|err| {worst:.3e}")
    return worst


def bound(flops, nbytes, peak_f32, peak_bw, peak_tf32):
    """The least time (ms) of f32-accurate work: the larger of its products
    in 3xTF32 on the tensor cores (3 FLOP / the TF32 rate) and its bytes over
    HBM bandwidth, and what bounds it; with the f32 CUDA-core bound beside
    it, the yardstick before the engine moved to the tensor cores."""
    t_ops, t_bytes = 3.0 * flops / peak_tf32 * 1e3, nbytes / peak_bw * 1e3
    t_f32 = max(flops / peak_f32 * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", t_f32
    return t_bytes, "bytes", t_f32


def nbytes_of(tensors) -> int:
    return sum(4 * t.numel() for t in tensors if t is not None)


def entry(name, err, ms, plain_ms, flops, nbytes, pk, **extra):
    b_ms, b_by, b_f32 = bound(flops, nbytes, *pk)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
            "tolerance": f"{RTOL} * max|ref|", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_core_ms": b_f32,
            "library_ms": None, "flop": flops, "bytes": nbytes, **extra}


def shape_timing(res, pk):
    """ms, plain ms and bounds of one kernel check at one shape."""
    b_ms, b_by, b_f32 = bound(res["flops"], res["nbytes"], *pk)
    return {"ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "bound_f32_core_ms": b_f32, "flop": res["flops"],
            "bytes": res["nbytes"], "max_abs_err": res["err"]}


def grad_shapes(int_widths, widths, dims=2, n_int=N_INT, n_bnd=N_BND):
    """(rows, K, N) of every weight gradient one engine backward contracts:
    the internal launch's (v, J, H) stash rows, then the boundary launch's."""
    rows = (BATCH * n_int * (1 + 2 * dims), BATCH * n_bnd)
    return ([(rows[0], int_widths[i], int_widths[i + 1]) for i in range(len(widths) - 1)]
            + [(rows[1], widths[i], widths[i + 1]) for i in range(len(widths) - 1)])


_WEIGHT_GRAD_TIMES = {}  # (rows, K, N) -> (err, ms, library_ms), once a run


def time_weight_grads(torch, shapes, pk=None):
    """The engine's weight_grad alone at each (rows, K, N) on random rows,
    held to its plain version, cuBLAS's a.t() @ g in full f32 (TF32 off),
    within RTOL and timed beside it: the backward's split into its
    weight gradients and its rows sweep. Returns the sums over the shapes
    (ms, library_ms, flops, nbytes, err) and each shape's times; with
    ``pk`` also their bounds. A shape met again in the run reuses its
    measurement."""
    from porous_cfd_tpu_torch.ops import mlp_prop_cuda
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"ms": 0.0, "library_ms": 0.0, "flops": 0.0, "nbytes": 0.0, "err": 0.0,
           "layers": []}
    for rows, k, n in shapes:
        if (rows, k, n) not in _WEIGHT_GRAD_TIMES:
            a = torch.randn((rows, k), generator=gen, device=dev)
            g = torch.randn((rows, n), generator=gen, device=dev)
            err = check_close(f"weight_grad ({rows}, {k}) x ({rows}, {n})",
                              [("dW", mlp_prop_cuda.weight_grad(a, g), a.t() @ g)], quiet=True)
            _WEIGHT_GRAD_TIMES[rows, k, n] = (
                err, time_ms(torch, lambda: mlp_prop_cuda.weight_grad(a, g)),
                time_ms(torch, lambda: a.t() @ g))
            del a, g
        err, ms, lib = _WEIGHT_GRAD_TIMES[rows, k, n]
        out["layers"].append({"rows": rows, "k": k, "n": n, "ms": ms, "library_ms": lib})
        out["ms"] += ms
        out["library_ms"] += lib
        out["flops"] += 2.0 * rows * k * n
        out["nbytes"] += 4.0 * (rows * (k + n) + k * n)
        out["err"] = max(out["err"], err)
    if pk is not None:
        out.update({k: v for k, v in zip(("bound_ms", "bound_by", "bound_f32_core_ms"),
                                         bound(out["flops"], out["nbytes"], *pk))})
    return out


def split_backward(torch, bwd, shapes, pk):
    """Add to a backward row its weight gradients (time_weight_grads) and
    its rows sweep: the backward's time less theirs (the row kernels and
    the column sums)."""
    wg = time_weight_grads(torch, shapes, pk)
    bwd["extra"] = {**bwd.get("extra", {}), "weight_grad": wg,
                    "rows_sweep_ms": bwd["ms"] - wg["ms"]}
    bwd["err"] = max(bwd["err"], wg["err"])
    log(f"    rows sweep {bwd['ms'] - wg['ms']:.4f} ms, weight_grad {wg['ms']:.4f} ms "
        f"(cuBLAS f32 {wg['library_ms']:.4f} ms, 3xTF32 bound {wg['bound_ms']:.4f} ms)")


def kernel_report(log_text):
    """Per kernel family (the engine's forward and backward row kernels,
    weight_grad, pointnet_global's and sa_neighborhood's forward and
    backward tiles, sa_neighborhood's compaction) of one ``-Xptxas -v``
    report: instantiations, registers, the largest stack frame and spills,
    in bytes."""
    families = {}
    name = None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = next((f for f in ("mlp_prop_fwd", "mlp_prop_bwd_rows",
                                     "weight_grad_partial", "pointnet_fwd_tiles",
                                     "pointnet_bwd_tiles", "sa_fwd_tiles", "sa_bwd_tiles",
                                     "sa_bwd_prep") if f in line), None)
            if name:
                families.setdefault(name, {"count": 0, "registers": [], "stack": 0,
                                           "spill_stores": 0, "spill_loads": 0})
                families[name]["count"] += 1
        elif name and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            fam = families[name]
            fam["stack"] = max(fam["stack"], nums[0])
            fam["spill_stores"] = max(fam["spill_stores"], nums[1])
            fam["spill_loads"] = max(fam["spill_loads"], nums[2])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            families[name]["registers"].append(int(words[words.index("Used") + 1]))
            name = None
    return families


def adam_first_step_spread(g, tau, lr, eps):
    """The most Adam's first step lr g / (|g| + eps) changes when each
    gradient moves by up to tau (float64)."""
    g = g.double()

    def u(x):
        return lr * x / (x.abs() + eps)

    return (u(g + tau) - u(g)).abs().maximum((u(g - tau) - u(g)).abs())


def check_pointnet(layers, n_pts, x_grad, gen, tag, act="silu"):
    """pointnet_global forward (max and argmax) and backward against the
    plain version at (BATCH, n_pts, layers[0]) with activation ``act``,
    timed. Returns the forward's and the backward's (err, ms, plain ms,
    flops, bytes)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    from porous_cfd_tpu_torch.physics import analytic
    dev = torch.device("cuda", 0)
    name = f"pointnet_global {tag}"
    mlp = MLP(layers, activation=act, generator=gen).to(dev)
    x = torch.randn((BATCH, n_pts, layers[0]), generator=gen).to(dev)
    lin = mlp.linears
    with torch.no_grad():
        m_k, a_k = pointnet_cuda.pointnet_global(lin, x, act)
        torch.cuda.synchronize()
        m_p, a_p = pointnet_cuda.pointnet_global_plain(lin, x, act)
        torch.cuda.synchronize()
        err_f = check_close(name, [("max", m_k, m_p)])
        g_full = analytic.mlp_value(lin, x, act)
        top2 = torch.topk(g_full, 2, dim=-2).values
        decided = (top2[:, 0] - top2[:, 1]) > RTOL * m_p.abs().max()
        mismatch = int(((a_k[:, 0] != a_p[:, 0]) & decided).sum())
        log(f"  {name} argmax: {int(decided.sum())} of {decided.numel()} "
            f"channels decided, {mismatch} disagree")
        if mismatch:
            fail(f"{name} argmax disagrees with the plain version")
        del g_full, top2
        ms_f = time_ms(torch, lambda: pointnet_cuda.pointnet_global(lin, x, act))
        ms_fp = time_ms(torch, lambda: pointnet_cuda.pointnet_global_plain(lin, x, act))
    macs = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    fwd = {"err": err_f, "ms": ms_f, "plain_ms": ms_fp,
           "flops": 2.0 * BATCH * n_pts * macs,
           "nbytes": 4 * (x.numel() + sum(p.numel() for p in mlp.parameters())
                          + 2 * BATCH * layers[-1])}

    # backward on the kernel's winners (near-ties may legitimately pick
    # another row than torch.max); the pi-gano inputs need no gradient
    params = list(mlp.parameters())
    xg = x.clone().requires_grad_(x_grad)
    wrt = ([xg] if x_grad else []) + params
    m_k, a_k = pointnet_cuda.pointnet_global(lin, xg, act)
    cot = torch.randn((BATCH, 1, layers[-1]), generator=gen).to(dev)
    got = torch.autograd.grad((m_k * cot).sum(), wrt)
    torch.cuda.synchronize()
    m_ref = pointnet_cuda.pointnet_global_at(lin, xg, act, a_k)
    loss_ref = (m_ref * cot).sum()
    ref = torch.autograd.grad(loss_ref, wrt, retain_graph=True)
    names = (["dx"] if x_grad else []) + [f"d{n}" for n, _ in mlp.named_parameters()]
    err_b = check_close(f"{name} backward", list(zip(names, got, ref)))
    w_g = [lin_.weight.detach() for lin_ in lin]
    b_g = [lin_.bias.detach() for lin_ in lin]
    dm = cot.contiguous()
    a_k = a_k.contiguous()

    def backward(winners=False):
        return pointnet_cuda.pointnet_global_backward(w_g, b_g, x, act, a_k, dm, x_grad,
                                                      winners)

    # the kernel's compaction against the plain one, and two runs bit for bit
    *first, (rows_k, slot_k, count_k) = backward(winners=True)
    rows_p, slot_p, count_p = pointnet_cuda.pointnet_winner_rows(a_k)
    rcap = rows_k.shape[1]
    if not (torch.equal(count_k.long(), count_p) and torch.equal(slot_k.long(), slot_p)
            and torch.equal(rows_k.long(), rows_p[:, :rcap])):
        fail(f"{name} backward: the winner compaction differs from pointnet_winner_rows")
    second = backward()
    flat = lambda r: [t for t in (r[0], *r[1], *r[2]) if t is not None]  # noqa: E731
    if not all(torch.equal(u, v) for u, v in zip(flat(first), flat(second))):
        fail(f"{name} backward: two runs differ")
    winners = int(count_p.sum())
    log(f"  {name} backward: {winners} winner rows of {BATCH * n_pts}, compaction equal to "
        f"pointnet_winner_rows, two runs bitwise equal")
    ms_b = time_ms(torch, backward)
    ms_bp = time_ms(torch, lambda: torch.autograd.grad(loss_ref, wrt, retain_graph=True))
    # the work these inputs need: recompute the lower layers at the winner
    # rows, z at each (case, channel) winner, then dW, db and da of the last
    # layer and dX, dW of the lower layers at the winners
    lower = sum(a * b for a, b in zip(layers[:-2], layers[1:-1]))
    last = layers[-2] * layers[-1] * BATCH
    bwd = {"err": err_b, "ms": ms_b, "plain_ms": ms_bp,
           "flops": 2.0 * (winners * lower * 3 + last * 3),
           "nbytes": nbytes_of([x, *params, m_k, cot, *got]) + 4 * a_k.numel(),
           "winner_rows": winners}
    return fwd, bwd


def trunk_mode(last_activation=True, reduction=True):
    """The name of a neural_ops_prop mode, as ``neural_op_cuda.MODE_COUNTS``
    keys it; None for the default one."""
    return "_".join(m for m, on in (("linear_last", not last_activation),
                                    ("no_reduction", not reduction)) if on) or None


def check_trunk(gen, last_activation=True, reduction=True, n_local=PG_LOCAL[-1],
                f=PG_BRANCH[-1], n_ops=PG_OPERATORS, rates=PG_DROPOUT, n_red=3, dims=2,
                tag=None):
    """neural_ops_prop forward and backward against the plain version at the
    pi-gano envelope (or at ``n_local`` local columns, ``n_ops`` operators
    ``f`` wide with dropout ``rates``, a reduction to ``n_red`` and ``dims``
    dimensions: windbreaks' trunk), dropout on and off, timed, in one mode:
    the default (an activated last operator and the reduction), or without
    the last activation and/or the reduction (pi-gano-full's trunks run
    without both, the outputs F wide). Returns the forward's and the
    backward's (err, ms, plain ms, flops, bytes, extra timings)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import NeuralOperatorSequential, dense
    from porous_cfd_tpu_torch.ops import dropout, mlp_prop_cuda, neural_op_cuda
    dev = torch.device("cuda", 0)
    mode = trunk_mode(last_activation, reduction)
    label = "neural_ops_prop" + (f" {mode}" if mode else "") + (f" {tag}" if tag else "")
    n_out = n_red if reduction else f
    geom_width = f - n_local
    ops = NeuralOperatorSequential(n_ops, f, rates, "silu",
                                   last_activation=last_activation, generator=gen).to(dev)
    red = dense(f, n_red, gen).to(dev) if reduction else None
    linears = ops.linears + ([red] if reduction else [])
    params = [p for lin in linears for p in (lin.weight, lin.bias)]

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v, v_b = rnd(BATCH, N_INT, n_local), rnd(BATCH, N_BND, n_local)
    jt = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    ht = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    geom = rnd(BATCH, 1, geom_width)
    par = (torch.rand((BATCH, 1, f), generator=gen) + 0.5).to(dev)

    seed = neural_op_cuda.trunk_seed(SEED)
    if mode is None and tag is None:
        mask = dropout.keep_mask(seed, 1, BATCH, N_INT + N_BND, f, 0.1, dev)
        kept = float((mask > 0).float().mean())
        log(f"  kept fraction of a ({BATCH}, {N_INT + N_BND}, {f}) trunk mask at rate 0.1: "
            f"{kept:.6f}")
        if abs(kept - 0.9) > 0.002:
            fail(f"trunk kept fraction {kept} not within 0.9 +- 0.002")
        del mask

    leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, geom, par)]
    names = ["dv", "djt", "dht", "dv_b", "dgeom", "dpar"] + [
        f"d{n}" for n, _ in ops.named_parameters()] + ([
            f"dreduction.{n}" for n, _ in red.named_parameters()] if reduction else [])
    errs, timing = [], {}
    for drop in (rates, None):
        dtag = "dropout" if drop else "no dropout"
        dargs = (ops.linears, red, n_local, *leaves, "silu", drop, drop is None, SEED)
        kw = {"last_activation": last_activation}
        out_k = neural_op_cuda.neural_ops_prop(*dargs, **kw)
        if out_k[0].shape[-1] != n_out:
            fail(f"{label}: output width {out_k[0].shape[-1]} != {n_out}")
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                  leaves + params)
        torch.cuda.synchronize()
        out_p = neural_op_cuda.neural_ops_prop_plain(*dargs, **kw)
        errs.append(check_close(f"{label} forward, {dtag}",
                                list(zip(("v", "jac", "lap"), out_k, out_p))))
        loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
        ref = torch.autograd.grad(loss_ref, leaves + params, retain_graph=True)
        errs.append(check_close(f"{label} backward, {dtag}", list(zip(names, got, ref)),
                                quiet=mode is not None))
        with torch.no_grad():
            timing[f"ms_{dtag}"] = time_ms(
                torch, lambda: neural_op_cuda.neural_ops_prop(*dargs, **kw))
            timing[f"plain_ms_{dtag}"] = time_ms(
                torch, lambda: neural_op_cuda.neural_ops_prop_plain(*dargs, **kw), n=5)
        if drop:
            timing["plain_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                loss_ref, leaves + params, retain_graph=True), n=5)
            widths = (n_local,) + (f,) * n_ops + ((n_red,) if reduction else ())
            meta_rates = (mlp_prop_cuda.dropout_rates(drop, n_ops, False)
                          + (0.0,) * reduction)
            meta_kw = dict(reduction=reduction, last_activation=last_activation)
            meta = mlp_prop_cuda.Meta(n_local, "silu", meta_rates, seed, dims, BATCH, N_INT,
                                      N_BND, widths, **meta_kw)
            with torch.no_grad():
                weights = [lin.weight.detach() for lin in linears]
                biases = [lin.bias.detach() for lin in linears[1:]]
                ctx = torch.nn.functional.linear(
                    geom[:, 0], linears[0].weight[:, n_local:], linears[0].bias).contiguous()
                par2 = par[:, 0].contiguous()
                _, _, _, stashes = mlp_prop_cuda.forward(neural_op_cuda.TRUNK, meta, v, jt, ht,
                                                         v_b, ctx, weights, biases, True, par2)
                gv, gj, gh = (c.contiguous() for c in cots)
                timing["bwd_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop_backward(
                    meta, weights, par2, stashes, gv, gj, gh))
                meta_int = mlp_prop_cuda.Meta(n_local, "silu", meta_rates, seed, dims, BATCH,
                                              N_INT, 0, widths, **meta_kw)
                gv_int = gv[:, :N_INT].contiguous()
                timing["bwd_internal_ms"] = time_ms(
                    torch, lambda: neural_op_cuda.neural_ops_prop_backward(
                        meta_int, weights, par2, stashes[:2], gv_int, gj, gh))
            bwd_bytes = nbytes_of([v, jt, ht, v_b, geom, par, *params, *cots, *got])
            del stashes
        del out_k, out_p, got, ref, loss_ref
    with torch.no_grad():
        args_int = (ops.linears, red, n_local, v, jt, ht, None, geom, par, "silu")
        timing["ms_internal_launch_no_dropout"] = time_ms(
            torch, lambda: neural_op_cuda.neural_ops_prop(*args_int,
                                                          last_activation=last_activation))
    macs = n_local * f + (n_ops - 1) * f * f + (f * n_red if reduction else 0)
    rows = BATCH * N_INT * (1 + 2 * dims) + BATCH * N_BND
    flops = 2.0 * rows * macs + 2.0 * BATCH * geom_width * f
    fwd_bytes = nbytes_of([v, jt, ht, v_b, geom, par, *params]) + 4 * (
        BATCH * (N_INT + N_BND) * n_out + 2 * BATCH * N_INT * n_out * dims)
    log(f"  {label}: forward {timing['ms_dropout']:.4f} ms (plain "
        f"{timing['plain_ms_dropout']:.3f}), backward {timing['bwd_ms']:.4f} ms (plain "
        f"{timing['plain_bwd_ms']:.3f}), dropout {list(rates)}")
    fwd = {"err": max(errs[0], errs[2]), "ms": timing["ms_dropout"],
           "plain_ms": timing["plain_ms_dropout"], "flops": flops, "nbytes": fwd_bytes,
           "extra": {"ms_no_dropout": timing["ms_no dropout"],
                     "plain_ms_no_dropout": timing["plain_ms_no dropout"],
                     "ms_internal_launch_no_dropout":
                         timing["ms_internal_launch_no_dropout"], "out_width": n_out}}
    bwd = {"err": max(errs[1], errs[3]), "ms": timing["bwd_ms"],
           "plain_ms": timing["plain_bwd_ms"], "flops": 2.0 * flops, "nbytes": bwd_bytes,
           "extra": {"ms_internal_launch": timing["bwd_internal_ms"]}}
    return fwd, bwd


def check_decoder(seg, seg_dropout, gen, tag, act="silu", n_int=N_INT, n_bnd=N_BND, dims=2):
    """decoder_prop against the plain version at ``seg`` widths and
    activation ``act`` over BATCH cases of ``n_int`` internal and ``n_bnd``
    boundary rows in ``dims`` dimensions: forward without dropout (both
    launches, and the internal
    launch alone), then forward and backward with ``seg_dropout`` (when the
    model has dropout) and without, timed at the first of those. Returns the
    forward's and the backward's (err, ms, plain ms, flops, bytes, extra
    timings)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import decoder_cuda, mlp_prop_cuda
    dev = torch.device("cuda", 0)
    dec = MLP(seg, seg_dropout, act, last_activation=False, generator=gen).to(dev)
    lin_d = dec.linears
    n_local = FE_LOCAL[-1]

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v = rnd(BATCH, n_int, n_local)
    jt = rnd(BATCH, dims, n_int, n_local, scale=0.5)
    ht = rnd(BATCH, dims, n_int, n_local, scale=0.5)
    v_b = rnd(BATCH, n_bnd, n_local)
    g = rnd(BATCH, 1, seg[0] - n_local)
    args = (lin_d, n_local, v, jt, ht, v_b, g, act)
    with torch.no_grad():
        out_k = decoder_cuda.decoder_prop(*args)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*args)
        torch.cuda.synchronize()
        err_dec = check_close(f"decoder_prop {tag}", list(zip(("v", "jac", "lap"), out_k,
                                                              out_p)))
        ms_dec = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args))
        ms_dec_p = time_ms(torch, lambda: decoder_cuda.decoder_prop_plain(*args))
        args_int = (lin_d, n_local, v, jt, ht, None, g, act)
        ms_dec_int = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args_int))
    macs_d = n_local * seg[1] + sum(a * b for a, b in zip(seg[1:-1], seg[2:]))
    rows = BATCH * n_int * (1 + 2 * dims) + BATCH * n_bnd
    flops = 2.0 * rows * macs_d + 2.0 * BATCH * (seg[0] - n_local) * seg[1]
    fwd_bytes = nbytes_of([v, jt, ht, v_b, g, *dec.parameters(), *out_k])
    del out_k, out_p

    leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, g)]
    params_d = list(dec.parameters())
    names = ["dv", "djt", "dht", "dv_b", "dg"] + [f"d{n}" for n, _ in dec.named_parameters()]
    errs, timing = [], {}
    configs = (seg_dropout, None) if seg_dropout and max(seg_dropout) > 0 else (None,)
    for drop in configs:
        dtag = f"dropout {max(drop)}" if drop else "no dropout"
        dargs = (lin_d, n_local, *leaves, act, drop, drop is None, SEED)
        out_k = decoder_cuda.decoder_prop(*dargs)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                  leaves + params_d)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*dargs)
        errs.append(check_close(f"decoder_prop {tag} forward, {dtag}",
                                list(zip(("v", "jac", "lap"), out_k, out_p))))
        loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
        ref = torch.autograd.grad(loss_ref, leaves + params_d, retain_graph=True)
        errs.append(check_close(f"decoder_prop {tag} backward, {dtag}",
                                list(zip(names, got, ref))))
        if drop is configs[0]:
            with torch.no_grad():
                timing["ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop(*dargs))
                timing["plain_ms"] = time_ms(torch,
                                             lambda: decoder_cuda.decoder_prop_plain(*dargs))
            timing["plain_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                loss_ref, leaves + params_d, retain_graph=True))
            rates = mlp_prop_cuda.dropout_rates(drop, len(lin_d), drop is None)
            meta = mlp_prop_cuda.Meta(n_local, act, rates, SEED, dims, BATCH, n_int, n_bnd,
                                      tuple([n_local] + seg[1:]))
            with torch.no_grad():
                weights = [p.detach() for p in (lin.weight for lin in lin_d)]
                ctx = torch.nn.functional.linear(g[:, 0], lin_d[0].weight[:, n_local:],
                                                 lin_d[0].bias).contiguous()
                _, _, _, stashes = mlp_prop_cuda.forward(
                    decoder_cuda.DECODER, meta, v, jt, ht, v_b, ctx, weights,
                    [lin.bias.detach() for lin in lin_d[1:]], True)
                gv, gj, gh = (c.contiguous() for c in cots)
                timing["bwd_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
                    meta, weights, stashes, gv, gj, gh))
                gj_none = torch.zeros_like(gj)
                timing["bwd_internal_ms"] = time_ms(
                    torch, lambda: decoder_cuda.decoder_prop_backward(
                        mlp_prop_cuda.Meta(n_local, act, meta.rates, SEED, dims, BATCH,
                                           n_int, 0, meta.widths),
                        weights, stashes[:2], gv[:, :n_int].contiguous(), gj_none, gj_none))
            bwd_bytes = nbytes_of([v, jt, ht, v_b, g, *params_d, *cots, *got])
            del stashes
        del out_k, out_p, got, ref, loss_ref
    fwd = {"err": max([err_dec] + errs[::2]), "ms": timing["ms"],
           "plain_ms": timing["plain_ms"], "flops": flops, "nbytes": fwd_bytes,
           "extra": {"ms_no_dropout": ms_dec, "plain_ms_no_dropout": ms_dec_p,
                     "ms_internal_launch_no_dropout": ms_dec_int}}
    bwd = {"err": max(errs[1::2]), "ms": timing["bwd_ms"],
           "plain_ms": timing["plain_bwd_ms"], "flops": 2.0 * flops, "nbytes": bwd_bytes,
           "extra": {"ms_internal_launch": timing["bwd_internal_ms"]}}
    return fwd, bwd


def coupled_inputs(model, batch):
    """The decoder's inputs on the coupled path of ``model`` (a coupled
    pipn on the card) for ``batch``: (v, jt, ht, v_b, g, zj0, zh0, jctx,
    hctx), the last two the ctx_width mode's context derivatives, channel
    f's J/H at its winner row in column f (nonzero at the winners only)."""
    import torch
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models import pipn
    from porous_cfd_tpu_torch.physics import analytic
    fe = model.module.feature_extract
    internal, boundary = split_contiguous(batch)
    feats = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
    n_int = internal["C"].shape[-2]
    with torch.no_grad():
        j0, h0 = analytic.identity_jacobian_t(internal["C"])
        v, jt, ht = analytic.mlp_prop_t(fe.local_feature.linears, internal["C"], j0, h0, "silu")
        v_b = analytic.mlp_value(fe.local_feature.linears, boundary["C"], "silu")
        g, rows, jw, hw = pipn.winner_terms(fe, v, jt, ht, v_b, feats[:, :n_int],
                                            feats[:, n_int:], "silu")
        w0g = model.module.decoder.linear_0.weight[:, v.shape[-1]:]
        zj0, zh0 = pipn.winner_add_terms(rows, jw, hw, w0g, n_int)
        idx = rows[:, None, None, :].expand(jw.shape[0], jw.shape[1], 1, jw.shape[2])
        ctx = []
        for w in (jw, hw):
            c = w.new_zeros((*jw.shape[:2], n_int, jw.shape[2]))
            ctx.append(c.scatter_(2, idx, w[:, :, None, :]))
    return [t.contiguous() for t in (v, jt, ht, v_b, g, zj0, zh0, *ctx)]


def check_decoder_coupled(model, batch, pk):
    """decoder_prop's j0_add and ctx_width modes against the plain version at
    the pipn shape on ``model``'s real inputs for ``batch``, forward and
    backward, dropout on and off, timed. Returns {mode: (fwd, bwd)}."""
    import torch
    from porous_cfd_tpu_torch.ops import decoder_cuda, mlp_prop_cuda
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 1)
    dec = model.module.decoder
    lin_d = dec.linears
    n_local, dims = FE_LOCAL[-1], 2
    v, jt, ht, v_b, g, zj0, zh0, jctx, hctx = coupled_inputs(model, batch)
    nnz = int((jctx != 0).any(-1).sum() + (hctx != 0).any(-1).sum())
    log(f"  coupled inputs: {int((zj0 != 0).any(-1).sum())} of {BATCH * dims * N_INT} J rows "
        f"carry layer-0 terms; {nnz} nonzero context rows (J and H)")
    params_d = list(dec.parameters())
    names = ["dv", "djt", "dht", "dv_b", "dg"] + [f"d{n}" for n, _ in dec.named_parameters()]
    widths = tuple([n_local] + SEG[1:])
    macs_d = n_local * SEG[1] + sum(a * b for a, b in zip(SEG[1:-1], SEG[2:]))
    rows = BATCH * N_INT * (1 + 2 * dims) + BATCH * N_BND
    base_flops = 2.0 * rows * macs_d + 2.0 * BATCH * (SEG[0] - n_local) * SEG[1]
    res = {}
    for mode, extra in (("j0_add", (zj0, zh0)), ("ctx_width", (jctx, hctx))):
        key = "j0_add" if mode == "j0_add" else "jctx_t"
        leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, g, *extra)]
        xnames = ["dja", "dha"] if mode == "j0_add" else ["djctx", "dhctx"]
        errs, timing = [], {}
        for drop in (SEG_DROPOUT, None):
            dtag = f"dropout {max(SEG_DROPOUT)}" if drop else "no dropout"
            kw = {key: leaves[5], key.replace("j", "h", 1): leaves[6]}
            dargs = (lin_d, n_local, *leaves[:5], "silu", drop, drop is None, SEED)
            out_k = decoder_cuda.decoder_prop(*dargs, **kw)
            cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
            got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                      leaves + params_d)
            torch.cuda.synchronize()
            out_p = decoder_cuda.decoder_prop_plain(*dargs, **kw)
            errs.append(check_close(f"decoder_prop {mode} forward, {dtag}",
                                    list(zip(("v", "jac", "lap"), out_k, out_p))))
            loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
            ref = torch.autograd.grad(loss_ref, leaves + params_d, retain_graph=True)
            errs.append(check_close(f"decoder_prop {mode} backward, {dtag}",
                                    list(zip(names[:5] + xnames + names[5:], got, ref))))
            if drop:
                with torch.no_grad():
                    timing["ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop(*dargs, **kw))
                    timing["plain_ms"] = time_ms(
                        torch, lambda: decoder_cuda.decoder_prop_plain(*dargs, **kw), n=5)
                timing["plain_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                    loss_ref, leaves + params_d, retain_graph=True), n=5)
                meta = mlp_prop_cuda.Meta(
                    n_local, "silu", tuple(float(r) for r in drop), SEED, dims, BATCH, N_INT,
                    N_BND, widths, SEG[0] - n_local if mode == "ctx_width" else 0,
                    mode == "j0_add")
                with torch.no_grad():
                    weights = [lin.weight.detach() for lin in lin_d]
                    cctx = torch.nn.functional.linear(g[:, 0], lin_d[0].weight[:, n_local:],
                                                      lin_d[0].bias).contiguous()
                    jt_in, ht_in = jt, ht
                    if mode == "ctx_width":
                        jt_in, ht_in = torch.cat([jt, jctx], -1), torch.cat([ht, hctx], -1)
                    ja = (zj0, zh0) if mode == "j0_add" else (None, None)
                    _, _, _, stashes = mlp_prop_cuda.forward(
                        decoder_cuda.DECODER, meta, v, jt_in, ht_in, v_b, cctx, weights,
                        [lin.bias.detach() for lin in lin_d[1:]], True, None, *ja)
                    gv, gj, gh = (c.contiguous() for c in cots)
                    timing["bwd_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
                        meta, weights, stashes, gv, gj, gh))
                del stashes
            del out_k, out_p, got, ref, loss_ref
        ctx_flops = 0.0
        if mode == "ctx_width":   # the context rows this data needs: the nonzero ones
            ctx_flops = 2.0 * nnz * (SEG[0] - n_local) * SEG[1]
        else:                     # the two additions
            ctx_flops = 2.0 * zj0.numel()
        flops = base_flops + ctx_flops
        ins = [v, jt, ht, v_b, g, *extra, *params_d]
        fwd = {"err": max(errs[0], errs[2]), "ms": timing["ms"], "plain_ms": timing["plain_ms"],
               "flops": flops, "nbytes": nbytes_of(ins) + 4 * (BATCH * (N_INT + N_BND) * 3
                                                              + 2 * BATCH * N_INT * 3 * dims),
               "extra": {"nonzero_context_rows": nnz} if mode == "ctx_width" else {}}
        bwd = {"err": max(errs[1], errs[3]), "ms": timing["bwd_ms"],
               "plain_ms": timing["plain_bwd_ms"], "flops": 2.0 * flops,
               "nbytes": 2 * nbytes_of(ins) + 4 * (BATCH * (N_INT + N_BND) * 3
                                                  + 2 * BATCH * N_INT * 3 * dims)}
        log(f"  decoder_prop {mode}: forward {timing['ms']:.4f} ms (plain "
            f"{timing['plain_ms']:.3f}), backward {timing['bwd_ms']:.4f} ms (plain "
            f"{timing['plain_bwd_ms']:.3f})")
        res[mode] = (fwd, bwd)
    return res


def sa_backward_flops(widths, static, winners, winner_rows):
    """The winner-row backward's work, counted as pointnet_global_bwd's is:
    the last layer's z, da and dW at each (case, centroid, channel) winner;
    the hidden layers at the distinct winner rows, recomputed, their dW and,
    above layer 0, GZ W^T; the dynamic level's P row added and dP summed."""
    flops = 2.0 * winners * widths[-2] * 3
    for i in range(len(widths) - 2):
        flops += 2.0 * winner_rows * widths[i] * widths[i + 1] * (2 if i == 0 else 3)
    return flops + (0.0 if static else 2.0 * winner_rows * widths[1])


def sa_backward_flops_with_forward(widths, flops_f, winners, winner_rows):
    """The count the backward's bound used while the backward recomputed the
    whole level: the forward over every valid row (it found the winners),
    then, from the top, the last layer's dW, db and GZ W^T at each winner
    and each lower layer's dW, db and, above layer 0, GZ W^T at the winner
    rows. Logged beside the new count, so that the fall of the bound is not
    read as a change of speed."""
    flops = flops_f
    n_layers = len(widths) - 1
    for j in range(n_layers - 1, -1, -1):
        if j == n_layers - 1:
            macs, outs = winners * widths[j], winners
        else:
            macs, outs = winner_rows * widths[j] * widths[j + 1], winner_rows * widths[j + 1]
        flops += 2.0 * macs + outs
        if j > 0:
            flops += 2.0 * macs
    return flops


def sa_backward_bytes(call, arg, dout, rows):
    """The bytes the winner-row backward must move, counted as its work is,
    from the winners: the argmax and dout; at each distinct winner row its
    rel row and, static, its xg row, dynamic, its idx and each distinct row
    of P it reads once; the kernel's parameters, read, and their gradients
    and, dynamic, dP (B, n_src, F1), written. ``rows`` is the compaction
    (sa_winner_rows' first part: each case's winner rows c * K + k, then
    -1)."""
    import torch
    xg, rel, _, p, idx = call.tensors
    n_rows = int((rows >= 0).sum())
    row_bytes = rel.shape[-1] * 4 + (xg.shape[-1] * 4 if call.static else 8)
    total = arg.numel() * arg.element_size() + dout.numel() * 4 + n_rows * row_bytes
    params = sum(t.numel() for t in call.weights) + sum(t.numel() for t in call.biases
                                                         if t is not None)
    total += 2 * 4 * params
    if not call.static:
        flat = idx.reshape(call.b_cases, -1)
        src = torch.gather(flat, 1, rows.clamp(min=0))
        read = torch.zeros((call.b_cases, call.n_src + 1), dtype=torch.bool, device=idx.device)
        read.scatter_(1, torch.where(rows >= 0, src, call.n_src), True)  # past the rows: spare
        total += int(read[:, :-1].sum()) * p.shape[-1] * 4 + p.numel() * 4
    return float(total)


def sa_blocks_at(layers, n_cent, k, n_src, static):
    """sa_neighborhood's blocks (sa_cuda.blocks) at a level's shapes, on
    placeholder tensors of the card (the blocks depend on shapes only)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import sa_cuda
    dev = torch.device("cuda", 0)
    lin = MLP(layers, activation="silu").to(dev).linears
    rel = torch.zeros((BATCH, n_cent, k, 2), device=dev)
    mask = torch.ones((BATCH, n_cent, k), dtype=torch.bool, device=dev)
    idx = torch.zeros((BATCH, n_cent, k), dtype=torch.long, device=dev)
    f_in = layers[0] - 2
    xg = torch.zeros((BATCH, n_cent * k, f_in), device=dev) if static else None
    x = None if static else torch.zeros((BATCH, n_src, f_in), device=dev)
    return sa_cuda.blocks(sa_cuda.level_call(lin, x, idx, mask, rel, "silu", xg))


def check_sa_level(tag, conv_mlp, level, xg, n_src, gen, pk, empty_every=0, act="silu"):
    """sa_neighborhood against the plain version on the card at one radius
    level: ``level`` is the chain's entry (cent, idx, mask, rel, posc) of
    BATCH cases; static when ``xg`` (the chain's level-0 rows) is given,
    else dynamic on random features of ``n_src`` source rows. The forward's
    values within RTOL of the plain version and its argmax equal to the
    plain first maximal valid neighbour wherever the top two differ by more
    than RTOL; every gradient (dx through dP too) within RTOL of the plain
    level at the kernel's argmax (sa_neighborhood_at: a near-tie may pick
    another row than torch.max, as pointnet's check allows); the backward's
    compaction equal to sa_winner_rows, two backward runs bit for bit; with
    ``empty_every``, the level again with that share of its neighbourhoods
    emptied (0 out, no gradient). Timed with CUDA events; the forward's
    work counts the valid neighbour rows, the backward's its winners
    (sa_backward_flops, with the count before the winner-row backward
    logged beside it). Returns {"fwd": ..., "bwd": ...}, each the level's
    shape and shape_timing. ``act`` is the level's activation."""
    import torch
    from porous_cfd_tpu_torch.ops import sa_cuda
    dev = torch.device("cuda", 0)
    res = {}
    lin = conv_mlp.linears
    _, idx, mask, rel, _ = level[:5]
    static = xg is not None
    f_in = lin[0].weight.shape[1] - rel.shape[-1]
    x = None
    if not static:
        x = torch.randn((BATCH, n_src, f_in), generator=gen).to(dev).requires_grad_()
    params = [t for layer in lin for t in (layer.weight, layer.bias)]
    wrt = params + ([] if static else [x])
    names = [f"d{n}" for n, _ in conv_mlp.named_parameters()]
    names += [] if static else ["dx"]
    out = sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, act, xg)
    cot = torch.randn(out.shape, generator=gen).to(dev)
    got = torch.autograd.grad((out * cot).sum(), wrt)
    x_in = None if x is None else x.detach()
    call = sa_cuda.level_call(lin, x_in, idx, mask, rel, act, xg)
    with torch.no_grad():  # the argmax the backward was given: same kernel, same inputs
        arg = sa_cuda._forward(call)[1]
    torch.cuda.synchronize()
    with torch.no_grad():
        ref_out, ref_arg = sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel, act, xg,
                                                         with_argmax=True)
        h = sa_cuda._plain_rows(lin, x, idx, mask, rel, act, xg)
        top2 = torch.topk(h.masked_fill(~mask[..., None], -1e30), 2, dim=2).values
        decided = (top2[:, :, 0] - top2[:, :, 1]) > RTOL * ref_out.abs().max()
        decided |= mask.sum(-1, keepdim=True) < 2
        mismatch = int((arg != ref_arg)[decided].sum())
        del h, top2
    err_f = check_close(f"sa_neighborhood {tag}", [("out", out.detach(), ref_out)])
    log(f"  sa_neighborhood {tag} argmax: {int(decided.sum())} of {decided.numel()} "
        f"channels decided, {mismatch} disagree")
    if mismatch:
        fail(f"sa_neighborhood {tag}: argmax disagrees with the plain version")
    ref_at = sa_cuda.sa_neighborhood_at(lin, x, idx, mask, rel, act, arg, xg)
    loss_ref = (ref_at * cot).sum()
    ref = torch.autograd.grad(loss_ref, wrt, retain_graph=True)
    err_b = check_close(f"sa_neighborhood {tag} backward", list(zip(names, got, ref)))

    def backward(winners=False):
        return sa_cuda.sa_neighborhood_backward(call, arg, cot, winners)

    # the card's compaction against the plain one, two runs bit for bit
    first = backward(winners=True)
    rows_p, slot_p, count_p = sa_cuda.sa_winner_rows(arg, mask)
    rows_k, slot_k, count_k = first[3]
    if not (torch.equal(count_k.long(), count_p) and torch.equal(slot_k.long(), slot_p)
            and torch.equal(rows_k.long(), rows_p)):
        fail(f"sa_neighborhood {tag} backward: the compaction differs from sa_winner_rows")
    second = backward()
    flat = lambda r: [t for t in (*r[0], *r[1], r[2]) if t is not None]  # noqa: E731
    if not all(torch.equal(u, v) for u, v in zip(flat(first), flat(second))):
        fail(f"sa_neighborhood {tag} backward: two runs differ")
    with torch.no_grad():
        ms_f = time_ms(torch, lambda: sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, act,
                                                              xg))
        ms_fp = time_ms(torch, lambda: sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel,
                                                                     act, xg))
        ms_b = time_ms(torch, backward)
    ms_bp = time_ms(torch, lambda: torch.autograd.grad(loss_ref, wrt, retain_graph=True),
                    n=5)
    # the forward's work: the valid neighbour rows through the first
    # layer on [xg || rel] (static) or rel (dynamic, P's row is added)
    # and the other layers; the backward's at its winners
    rows = int(mask.sum())
    widths = call.widths
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    flops_f = 2.0 * rows * macs + (0.0 if static else rows * widths[1])
    winners = int((arg >= 0).sum())
    winner_rows = int(count_p.sum())
    flops_b = sa_backward_flops(widths, static, winners, winner_rows)
    flops_b_old = sa_backward_flops_with_forward(widths, flops_f, winners, winner_rows)
    inputs = [xg if static else call.tensors[3], rel, *params]
    side = mask.numel() + (0 if static else 8 * idx.numel())
    bytes_f = nbytes_of(inputs + [out]) + side + arg.numel()
    bytes_b = sa_backward_bytes(call, arg, cot, rows_p)
    mean_nbrs = float(mask.sum(-1).float().mean())
    shape = {"centroids": list(mask.shape[:2]), "neighbors": mask.shape[2],
             "widths": widths, "valid_rows": rows, "mean_valid_neighbors": mean_nbrs}
    shapes = {"fwd": shape,
              "bwd": {**shape, "winners": winners, "winner_rows": winner_rows,
                      "flop_counted_with_forward": flops_b_old}}
    for key, err, ms, pms, fl, by in (("fwd", err_f, ms_f, ms_fp, flops_f, bytes_f),
                                      ("bwd", err_b, ms_b, ms_bp, flops_b, bytes_b)):
        res[key] = {**shapes[key], **shape_timing({"err": err, "ms": ms,
                                                   "plain_ms": pms, "flops": fl,
                                                   "nbytes": by}, pk)}
    log(f"  sa_neighborhood {tag}: {rows} valid rows, {mean_nbrs:.2f} valid neighbours "
        f"per centroid, {winners} winners on {winner_rows} distinct rows (compaction equal "
        f"to sa_winner_rows, two backwards bitwise equal); backward work {flops_b:.4g} "
        f"FLOP at the winners ({flops_b_old:.4g} as counted with a forward); forward "
        f"{ms_f:.4f} ms (plain {ms_fp:.4f}), backward {ms_b:.4f} ms (plain {ms_bp:.4f})")
    if empty_every:  # every empty_every-th neighbourhood emptied
        empty = mask.clone()
        empty[:, ::empty_every] = False
        out_e = sa_cuda.sa_neighborhood(lin, x, idx, empty, rel, act)
        got_e = torch.autograd.grad((out_e * cot).sum(), wrt)
        with torch.no_grad():
            arg_e = sa_cuda._forward(sa_cuda.level_call(lin, x_in, idx, empty, rel,
                                                        act))[1]
        ref_e = sa_cuda.sa_neighborhood_plain(lin, x, idx, empty, rel, act)
        ref_ge = torch.autograd.grad(
            (sa_cuda.sa_neighborhood_at(lin, x, idx, empty, rel, act, arg_e) * cot).sum(),
            wrt)
        check_close("sa_neighborhood emptied", [("out", out_e.detach(), ref_e.detach())]
                    + list(zip(names, got_e, ref_ge)), quiet=True)
        if not (bool((out_e.detach()[:, ::empty_every] == 0).all())
                and bool((arg_e[:, ::empty_every] == -1).all())):
            fail("sa_neighborhood: an empty neighbourhood did not give 0 and argmax -1")
        log(f"  sa_neighborhood {tag}: every neighbourhood {empty_every} apart emptied "
            "gives 0")
    del out, got, ref, ref_out, ref_at, loss_ref, call, first, second
    return res


def check_sa(seq, chain, gen, pk, n_levels=len(PP_RADIUS), act="silu"):
    """sa_neighborhood (check_sa_level) at the two radius levels of ``seq``
    (a SetAbstractionSeq: PIPN++'s, or PI-GANO++'s at 32 neighbours): level
    0 static on ``chain`` (the model's precompute of BATCH cases: xg, rel,
    mask), level 1 dynamic on random level-0 features with the chain's idx,
    rel and mask, and again with every seventh neighbourhood emptied.
    Returns (fwd, bwd) dicts with the two levels summed and each level's
    numbers in ``extra``."""
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    nbrs = extract_sa_neighbors(chain, n_levels)
    res = {"fwd": {}, "bwd": {}}
    for i, tag in ((0, "level 0 static"), (1, "level 1 dynamic")):
        static = i == 0
        level = check_sa_level(tag, getattr(seq, f"sa_{i}").conv_mlp, nbrs[i],
                               nbrs[0][5] if static else None,
                               0 if static else nbrs[i - 1][0].shape[1], gen, pk,
                               0 if static else 7, act)
        for key in res:
            res[key][tag] = level[key]
    return sum_levels(res)


def sum_levels(res):
    """(fwd, bwd) of several levels' checks: the worst error, the summed
    times and work, each level's numbers in ``extra``."""
    summed = []
    for key in ("fwd", "bwd"):
        levels = res[key].values()
        summed.append({"err": max(v["max_abs_err"] for v in levels),
                       "ms": sum(v["ms"] for v in levels),
                       "plain_ms": sum(v["plain_ms"] for v in levels),
                       "flops": sum(v["flop"] for v in levels),
                       "nbytes": sum(v["bytes"] for v in levels),
                       "extra": {"levels": res[key]}})
    return summed


def fps_levels(torch, pos, levels, tag, plain=True):
    """FPS over pos (B, N, D) on the card at a chain of levels (level i + 1
    samples level i's centroids): at each level the kernel's indices must
    EQUAL the plain version's and one call must make one launch. Returns
    each level's numbers and the sums of ms, plain ms, flops and bytes."""
    from porous_cfd_tpu_torch.models.neighbors import gather_points
    from porous_cfd_tpu_torch.ops import fps_cuda
    fps = fps_cuda.farthest_point_sampling
    out = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "nbytes": 0,
           "levels": {}}
    for i, n_samples in enumerate(levels):
        b, n, d = pos.shape
        before = fps.launches
        cent = fps(pos, n_samples)
        torch.cuda.synchronize()
        if fps.launches != before + 1:
            fail(f"FPS {tag} level {i}: {fps.launches - before} launches, not 1")
        ref = fps_cuda.farthest_point_sampling_plain(pos, n_samples)
        if not torch.equal(cent, ref):
            fail(f"FPS {tag} level {i}: {int((cent != ref).sum())} of {cent.numel()} picks "
                 "differ from the plain version")
        ms = time_ms(torch, lambda: fps(pos, n_samples))
        dev_ms = kernel_times(torch, lambda: fps(pos, n_samples))["device_ms"]
        pms = (time_ms(torch, lambda: fps_cuda.farthest_point_sampling_plain(pos, n_samples),
                       n=3, warmup=1) if plain else None)
        # per pick and point: d subtractions, d products, d - 1 sums, a min
        # and a compare
        flops = float(b * (n_samples - 1) * n * (3 * d + 1))
        nbytes = 4 * pos.numel() + 8 * cent.numel()
        design = fps_cuda.fps_design(b, n, d)._asdict()
        log(f"  FPS {tag} level {i}: ({b}, {n}, {d}) -> {n_samples}, design {design}, indices "
            f"equal to the plain version's; {ms:.4f} ms, device {dev_ms:.4f} ms, "
            f"{1e3 * dev_ms / max(n_samples - 1, 1):.4f} us a pick"
            + (f" (plain {pms:.2f} ms)" if plain else ""))
        out["levels"][f"level_{i}"] = {"input": [b, n, d], "samples": n_samples, "ms": ms,
                                       "device_ms": dev_ms, "plain_ms": pms, "flop": flops,
                                       "bytes": nbytes, "design": design}
        for key, val in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", pms or 0.0),
                         ("flops", flops), ("nbytes", nbytes)):
            out[key] += val
        pos = gather_points(pos, cent)
    return out


def check_fps(data, levels):
    """FPS on the card: PIPN++'s two levels over every case of ``data`` (its
    boundary clouds, then the level-0 centroids), the same for one case (a
    new geometry), the latency floor (one 32-point cloud, a point a lane)
    and a design-B cloud past one block's capacity. Indices EQUAL to the
    plain version's everywhere, one launch a call. Returns the summed
    numbers of the B = N_CASES levels, with the rest under ``extra``."""
    import torch
    from porous_cfd_tpu_torch.ops import fps_cuda
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    pos = data.data[:, N_INT:, data.column_indices("C")].contiguous().to(dev)
    res = fps_levels(torch, pos, levels, f"B={pos.shape[0]}")
    one = fps_levels(torch, pos[:1].contiguous(), levels, "B=1")
    # the latency floor: the kernel's own chain a pick with one point a
    # lane, (1, FLOOR_N, 2) -> FLOOR_N, and its cost a pick as the slope to
    # -> FLOOR_PICKS (past N the picks repeat point 0, the same work a
    # pick), free of the launch and the loads; device ms
    floor_pos = (torch.rand((1, FLOOR_N, 2), generator=gen) * 2 - 1).to(dev)
    floor_short = fps_levels(torch, floor_pos, [FLOOR_N], "floor", plain=False)["device_ms"]
    floor_long = fps_levels(torch, floor_pos, [FLOOR_PICKS], "floor",
                            plain=False)["device_ms"]
    per_pick = (floor_long - floor_short) / (FLOOR_PICKS - FLOOR_N)
    picks = sum(n - 1 for n in levels)
    floor_ms = per_pick * picks
    log(f"  FPS latency floor: {1e3 * per_pick:.4f} us a pick ({FLOOR_N} points -> "
        f"{FLOOR_N}: {floor_short:.4f} ms, -> {FLOOR_PICKS}: {floor_long:.4f} ms, device); "
        f"{floor_ms:.4f} ms for the levels' {picks} picks, "
        f"{100 * floor_ms / res['device_ms']:.1f}% of B={pos.shape[0]}'s device "
        f"{res['device_ms']:.4f} ms, {100 * floor_ms / one['device_ms']:.1f}% of B=1's "
        f"{one['device_ms']:.4f} ms")
    # design B: one large cloud, the plain version timed once
    big_pos = (torch.rand((1, *FPS_BIG[:2]), generator=gen) * 2 - 1).to(dev)
    fps = fps_cuda.farthest_point_sampling
    before = fps.launches
    big = fps(big_pos, FPS_BIG[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_ref = fps_cuda.farthest_point_sampling_plain(big_pos, FPS_BIG[2])
    torch.cuda.synchronize()
    big_plain_ms = 1e3 * (time.perf_counter() - t0)
    if fps.launches != before + 1 or not torch.equal(big, big_ref):
        fail(f"FPS design B (1, {FPS_BIG[0]}, {FPS_BIG[1]}) -> {FPS_BIG[2]}: "
             f"{int((big != big_ref).sum())} picks differ, {fps.launches - before} launches")
    big_ms = time_ms(torch, lambda: fps(big_pos, FPS_BIG[2]), n=3, warmup=1)
    big_design = fps_cuda.fps_design(1, *FPS_BIG[:2])._asdict()
    log(f"  FPS design B: (1, {FPS_BIG[0]}, {FPS_BIG[1]}) -> {FPS_BIG[2]}, design "
        f"{big_design}, indices equal to the plain version's; {big_ms:.3f} ms, "
        f"{1e3 * big_ms / (FPS_BIG[2] - 1):.4f} us a pick (plain {big_plain_ms:.1f} ms, once)")
    levels_b, device_ms = res.pop("levels"), res.pop("device_ms")
    res["extra"] = {**levels_b, "device_ms": device_ms, "at_b1": one["levels"],
                    "b1_ms": one["ms"], "b1_device_ms": one["device_ms"],
                    "latency_floor_ms": floor_ms, "latency_floor_us_per_pick": 1e3 * per_pick,
                    "latency_floor_share": floor_ms / device_ms,
                    "latency_floor_device_ms": {f"{FLOOR_N}_picks": floor_short,
                                                f"{FLOOR_PICKS}_picks": floor_long},
                    "design": {k: v["design"] for k, v in levels_b.items()},
                    "design_b_cloud": {"input": [1, *FPS_BIG[:2]], "samples": FPS_BIG[2],
                                       "design": big_design, "ms": big_ms,
                                       "plain_ms_once": big_plain_ms}}
    res["err"] = 0.0
    return res


def time_attach(torch, model, batch):
    """attach_neighbors of one batch on the card (FPS, the radius search and
    the gathers), CUDA-event ms, and FPS's part of it: events around each of
    its FPS calls (one launch each) through the neighbours module."""
    from porous_cfd_tpu_torch.models import neighbors
    fps = neighbors.farthest_point_sampling
    spans = []

    def timed_fps(pos, n_samples):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        cent = fps(pos, n_samples)
        end.record()
        spans.append((start, end))
        return cent

    attach_ms = time_ms(torch, lambda: model.attach_neighbors(batch))
    neighbors.farthest_point_sampling = timed_fps
    try:
        for _ in range(20):
            model.attach_neighbors(batch)
        torch.cuda.synchronize()
    finally:
        neighbors.farthest_point_sampling = fps
    fps_ms = sum(s.elapsed_time(e) for s, e in spans) / 20
    return {"cases": batch.data.shape[0], "attach_ms": attach_ms, "fps_ms": fps_ms,
            "fps_share": fps_ms / attach_ms}


def check_chain(model, cpu_model, data, n_levels=len(PP_RADIUS), k=PP_NEIGHBORS):
    """The boundary chain of every case of ``data`` on the card (FPS kernel,
    cuBLAS distances) against the CPU's (plain FPS, the CPU's BLAS): the
    centroids must be equal; the (centroid, slot) entries whose index or
    mask differ are counted (a point within about 1e-6 of r may fall on
    either side), and the float entries compared where the indices agree.
    Also the mean valid neighbours per level (at most ``k``), and the time of
    ``attach_neighbors`` of one batch of BATCH cases with FPS's part."""
    import torch
    dev = torch.device("cuda", 0)
    card = {key: v.cpu() for key, v in model.neighbor_precompute(data.to(dev)).items()}
    cpu = cpu_model.neighbor_precompute(data)
    report = {}
    for i in range(n_levels):
        if not torch.equal(card[f"_sa_cent_{i}"], cpu[f"_sa_cent_{i}"]):
            fail(f"chain level {i}: the card's centroids differ from the CPU's")
        differ = ((card[f"_sa_idx_{i}"] != cpu[f"_sa_idx_{i}"])
                  | (card[f"_sa_mask_{i}"] != cpu[f"_sa_mask_{i}"]))
        same = ~differ.any(-1)                       # centroids with equal neighbourhoods
        rel_err = float((card[f"_sa_rel_{i}"] - cpu[f"_sa_rel_{i}"])[same].abs().max())
        posc_err = float((card[f"_sa_posc_{i}"] - cpu[f"_sa_posc_{i}"]).abs().max())
        mean_nbrs = float(card[f"_sa_mask_{i}"].sum(-1).float().mean())
        report[f"level_{i}"] = {"centroids": list(card[f"_sa_cent_{i}"].shape),
                                "entries_differing": int(differ.sum()),
                                "entries": differ.numel(), "rel_max_abs_diff": rel_err,
                                "posc_max_abs_diff": posc_err,
                                "mean_valid_neighbors": mean_nbrs}
        log(f"  chain level {i}: centroids equal; {int(differ.sum())} of {differ.numel()} "
            f"(centroid, slot) entries differ between the card and the CPU; rel within "
            f"{rel_err:.2e}, posc within {posc_err:.2e}; {mean_nbrs:.2f} valid neighbours per "
            f"centroid (cap {k})")
    if "_sa_xg_0" in card:
        same0 = ((card["_sa_idx_0"] == cpu["_sa_idx_0"])
                 & (card["_sa_mask_0"] == cpu["_sa_mask_0"]))
        report["xg_max_abs_diff"] = float((card["_sa_xg_0"] - cpu["_sa_xg_0"])
                                          .reshape(*same0.shape, -1)[same0].abs().max())
        log(f"  chain level 0: xg within {report['xg_max_abs_diff']:.2e} where the entries "
            "agree")
    if "_fp_idx_0" in card:
        report["fp_idx"] = check_fp_idx(data, card, cpu, n_levels)
    from porous_cfd_tpu_torch.train.engine import gather_cases
    attach = time_attach(torch, model, gather_cases(data, torch.arange(BATCH)).to(dev))
    log(f"  attach_neighbors of {attach['cases']} cases (a new batch's cost before its first "
        f"prediction): {attach['attach_ms']:.4f} ms, FPS {attach['fps_ms']:.4f} ms of it "
        f"({100 * attach['fps_share']:.1f}%)")
    report["attach_neighbors"] = attach
    return report


def check_fp_idx(data, card, cpu, n_levels):
    """The U-Net precompute's FP kNN indices on the card (cuBLAS's
    expansion-form distances) against the CPU's: equal, except where an
    entry that differs picks a point whose expansion-form distance lies
    within FP_TIE of the CPU's pick, which f32 rounding may order either
    way (a row counts once however many of its k entries differ). Level i
    interpolates from encoder level L - i to L - i - 1 (L the global
    level)."""
    import torch
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models.neighbors import pairwise_sqdist
    internal, boundary = split_contiguous(data)
    level_pos = [torch.cat([internal["C"], boundary["C"]], dim=-2)]
    level_pos += [cpu[f"_sa_posc_{i}"] for i in range(n_levels)]
    level_pos.append(torch.zeros_like(level_pos[0][:, :1]))
    out = {}
    for i in range(len(level_pos) - 1):
        got, ref = card[f"_fp_idx_{i}"], cpu[f"_fp_idx_{i}"]
        src, query = level_pos[-1 - i], level_pos[-2 - i]
        rows = (got != ref).any(-1)
        ties = 0
        for b, m in rows.nonzero().tolist():
            d2 = pairwise_sqdist(query[b, m:m + 1], src[b])[0]
            diff = got[b, m] != ref[b, m]
            if float((d2[got[b, m][diff]] - d2[ref[b, m][diff]]).abs().max()) <= FP_TIE:
                ties += 1
            else:
                fail(f"FP level {i}: case {b} query {m} picks {got[b, m].tolist()} on the "
                     f"card, {ref[b, m].tolist()} on the CPU, not at a near-tie")
        out[f"level_{i}"] = {"idx": list(ref.shape), "rows_differing_at_near_ties": ties}
        log(f"  FP level {i} kNN {tuple(ref.shape)}: equal on the card and the CPU but "
            f"{ties} rows at a near-tie (within {FP_TIE:.0e})")
    return out


def derivatives_no_grad(model, batch):
    """(jac, lap) of the model's path (analytic, or the exact operator)."""
    import torch
    from porous_cfd_tpu_torch.train.engine import model_derivatives
    with torch.no_grad():
        return model_derivatives(model, batch, True)[1:]


def prediction_phase(label, model, cpu_model, data, scalers, counters, want, name, smi,
                     per_evaluate=None, share_aux=False, compare_cases=BATCH, row_mask=None,
                     points=(N_INT, N_BND, N_OBS), rtol=None, dims=2):
    """Verbose prediction of every case in batches of BATCH through
    ``evaluate``: launch counts per batch (``want``; ``per_evaluate`` more per
    call, from its ``attach_neighbors``), shapes, finiteness, the median time
    per batch of SLICE_RUNS runs, and the first ``compare_cases`` cases
    against the same module on the CPU, which builds its own per-dataset aux
    unless ``share_aux``. ``row_mask(model, cpu_model, on_card, on_cpu)``,
    if given, says which internal rows' derivatives and residuals are
    compared (all where None). ``points`` are the cases' (internal,
    boundary, observation) rows; ``rtol`` maps a compared label ("lap",
    ...) to a tolerance other than RTOL; ``dims`` the cases' dimensions (the
    fields are U and p, the residuals momentum and divergence)."""
    import torch
    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
    dev = model.device
    n_int, n_bnd = points[:2]
    evaluate(model, gather_cases(data, torch.arange(BATCH)), BATCH, scalers)  # warm-up

    for c in counters.values():
        c.launches = 0
    ev = evaluate(model, data, BATCH, scalers)
    counts = {k: c.launches for k, c in counters.items()}
    n_batches = len(ev.predictions)
    log(f"{label} prediction: {n_batches} batches, launches {counts}")
    per_evaluate = per_evaluate or {}
    if counts != {k: n * n_batches + per_evaluate.get(k, 0) for k, n in want.items()}:
        fail(f"{label} launch counts {counts} != {want} per batch over {n_batches} batches "
             f"and {per_evaluate} per evaluate")
    for i, (pred, extras) in enumerate(ev.predictions):
        if tuple(pred.data.shape) != (BATCH, n_int + n_bnd, dims + 1):
            fail(f"{label} batch {i}: fields shape {tuple(pred.data.shape)}")
        if tuple(extras.data.shape) != (BATCH, n_int, dims + 1):
            fail(f"{label} batch {i}: residual shape {tuple(extras.data.shape)}")
        if not (bool(pred.data.isfinite().all()) and bool(extras.data.isfinite().all())):
            fail(f"{label} batch {i}: non-finite fields or residuals")
    for key, val in ev.results.items():
        if val is not None and not bool(torch.isfinite(torch.as_tensor(val)).all()):
            fail(f"{label} evaluation result {key!r} is not finite")
    # the host-clock window is short, so the run is repeated and the median
    # reported with the spread
    runs_ms = sorted(t / n_batches * 1e3 for t in [ev.inference_time] + [
        evaluate(model, data, BATCH, scalers).inference_time
        for _ in range(SLICE_RUNS - 1)])
    ms_batch = statistics.median(runs_ms)
    cases_s = BATCH / ms_batch * 1e3
    log(f"{label} prediction: verbose prediction {ms_batch:.3f} ms per batch of {BATCH} "
        f"(median of {SLICE_RUNS} runs, {runs_ms[0]:.3f} to {runs_ms[-1]:.3f}), "
        f"{cases_s:.1f} cases/s ({name}; {smi})")

    # one batch on the card (with the model's per-dataset aux, as evaluate
    # runs it) against the same module and batch on the CPU, with the aux
    # the CPU builds itself; or with the card's (``share_aux``: a neighbour
    # chain built on each side may differ where a point lies within rounding
    # of a radius, and check_chain counts such entries)
    batch = gather_cases(data, torch.arange(compare_cases))
    on_card = model.attach_neighbors(batch.to(dev))
    on_cpu = on_card.to("cpu") if share_aux else cpu_model.attach_neighbors(batch)
    predict_g = make_predict_functions(model).predict_batch
    predict_c = make_predict_functions(cpu_model).predict_batch
    pred_g, extras_g = predict_g(on_card, True)
    out_g = [pred_g.data, *derivatives_no_grad(model, on_card)]
    cpu_model.module.load_state_dict(copy.deepcopy(model.module).cpu().state_dict())
    pred_c, extras_c = predict_c(on_cpu, True)
    out_c = [pred_c.data, *derivatives_no_grad(cpu_model, on_cpu)]
    rows = (slice(None) if row_mask is None
            else row_mask(model, cpu_model, on_card, on_cpu))
    check_close(f"{label} prediction card-vs-CPU", [
        ("fields", out_g[0].cpu(), out_c[0]), ("jac", out_g[1].cpu()[rows], out_c[1][rows]),
        ("lap", out_g[2].cpu()[rows], out_c[2][rows]),
        ("Momentum", extras_g["Momentum"].cpu()[rows], extras_c["Momentum"][rows]),
        ("div", extras_g["div"].cpu()[rows], extras_c["div"][rows])], rtol=rtol)
    return {"ms_per_batch": ms_batch, "cases_per_s": cases_s, "runs_ms_per_batch": runs_ms,
            "batches": n_batches, "batch_size": BATCH, "points": list(points),
            "launches_per_batch": {k: (v - per_evaluate.get(k, 0)) // n_batches
                                   for k, v in counts.items()},
            "launches_per_evaluate": per_evaluate}


def training_phase(label, full_model, data, counters, want, name, smi, model_type,
                   want_attach=None, share_aux=False, runs=TRAIN_RUNS, epochs=TRAIN_EPOCHS,
                   two_cases=(0, 1), weights=LOSS_WEIGHTS, points=(N_INT, N_BND, N_OBS),
                   pooled_rtol=None):
    """Training of ``full_model(device)`` with the fixed loss weights at
    batch BATCH: launch counts of ``attach_neighbors`` (``want_attach``,
    default none) and per step (``want``), finite non-zero gradients in
    every parameter, no synchronizing call in a step, the loss falling, steps/s over whole epochs (median of
    ``runs`` runs of ``epochs`` epochs), one step on the cases ``two_cases``
    against the CPU with dropout on (each side with its own per-dataset aux,
    or both with the card's if ``share_aux``), and a Trainer.fit whose
    checkpoints restore. ``weights`` are the fixed loss weights, ``points``
    the cases' (internal, boundary, observation) rows; ``pooled_rtol``
    ({parameter name prefix: rtol}) holds the gradients of a max-pooled
    encoder to its own tolerance in the card-vs-CPU step (near-tie
    winners), and their Adam step with it."""
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.profile_predict import sync_sites
    from porous_cfd_tpu_torch.train.engine import (gather_cases, make_optimizer,
                                                   make_train_functions)
    from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig, load_checkpoint
    dev = torch.device("cuda", 0)
    scaler = FixedLossScaler(weights)
    n_cases = len(data)
    steps_per_epoch = n_cases // BATCH
    model = full_model(dev)
    train_fns = make_train_functions(model, make_optimizer(model, steps_per_epoch), scaler)
    state = train_fns.init_state(seed=SEED)
    host_rng = np.random.default_rng(SEED)

    def perm():
        return host_rng.permutation(n_cases).reshape(steps_per_epoch, BATCH)

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts():
        return {k: c.launches for k, c in counters.items()}

    # the per-dataset aux, once
    reset_counts()
    dataset = model.attach_neighbors(data.to(dev))
    torch.cuda.synchronize()
    attach_counts = read_counts()
    want_attach = want_attach or {k: 0 for k in counters}
    log(f"{label} training: attach_neighbors of {n_cases} cases, launches {attach_counts}")
    if attach_counts != want_attach:
        fail(f"{label} launch counts of attach_neighbors {attach_counts} != {want_attach}")

    # one step: launches and gradients
    reset_counts()
    state, m = train_fns.train_step(state, gather_cases(dataset, torch.as_tensor(perm()[0])))
    torch.cuda.synchronize()
    step_counts = read_counts()
    log(f"{label} training: one step, launches {step_counts}")
    if step_counts != want:
        fail(f"{label} launch counts per step {step_counts} != {want}")
    groups = {}
    for pname, p in model.module.named_parameters():
        if p.grad is None or not bool(p.grad.isfinite().all()):
            fail(f"{label} parameter {pname}: no finite gradient")
        if not bool((p.grad != 0).any()):
            fail(f"{label} parameter {pname}: gradient is zero")
        group = pname.split(".")[0]
        groups[group] = groups.get(group, 0) + 1
    log(f"  every parameter ({len(list(model.module.parameters()))}; by group {groups}) has "
        f"a finite, non-zero gradient; step-1 total loss {float(m[0]):.6f}")

    # the step queues its work and returns: train/engine.py's contract is no
    # host sync inside it. One more step under set_sync_debug_mode("warn")
    # counts the calls that make the host wait for the card.
    idx = torch.as_tensor(perm()[0], device=dev)
    sites = sync_sites(lambda: train_fns.train_step(state, gather_cases(dataset, idx)))
    log(f"  synchronizing calls in one step: {len(sites)}"
        + "".join(f"\n    {site}" for site in sites))
    if sites:
        fail(f"{label}: {len(sites)} synchronizing calls in one training step")

    # steps/s as bench.py measures it: whole epochs between two syncs, after
    # a warm-up epoch; the median of ``runs`` runs of ``epochs`` epochs
    state, m_warm = train_fns.train_epoch(state, dataset, perm())
    epoch_totals = [float(m_warm[0])]
    run_ms = []
    reset_counts()
    for _ in range(runs):
        perms = [perm() for _ in range(epochs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m_epochs = train_fns.train_epochs(state, dataset, perms)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3 / (epochs * steps_per_epoch))
        epoch_totals += m_epochs[:, 0].cpu().tolist()
    train_counts = read_counts()
    n_steps = runs * epochs * steps_per_epoch
    if train_counts != {k: n * n_steps for k, n in want.items()}:
        fail(f"{label} launch counts {train_counts} over {n_steps} steps != {want} per step")
    if not all(map(lambda t: t == t and abs(t) < float("inf"), epoch_totals)):
        fail(f"{label}: non-finite epoch loss")
    log(f"  epoch mean total loss: first {epoch_totals[0]:.6f}, last "
        f"{epoch_totals[-1]:.6f} over {len(epoch_totals)} epochs")
    if not epoch_totals[-1] < epoch_totals[0]:
        fail(f"{label}: the total loss did not fall")
    ms_step = statistics.median(run_ms)
    steps_s = 1e3 / ms_step
    run_ms.sort()
    log(f"{label} training: {ms_step:.3f} ms per step, {steps_s:.2f} steps/s at batch "
        f"{BATCH} (median of {runs} runs of {epochs} epochs x "
        f"{steps_per_epoch} steps, {run_ms[0]:.3f} to {run_ms[-1]:.3f} ms/step; "
        f"{name}; {smi})")
    per_step = {k: v // n_steps for k, v in train_counts.items()}
    del state, train_fns, model, dataset

    # one step on 2 cases, card against CPU, dropout on
    two = gather_cases(data, torch.as_tensor(two_cases))
    res, two_card = [], None
    for device in (dev, torch.device("cpu")):
        mdl = full_model(device)
        if share_aux and two_card is not None:
            two_dev = two_card.to(device)
        else:
            two_dev = two_card = mdl.attach_neighbors(two.to(device))
        f2 = make_train_functions(mdl, make_optimizer(mdl, steps_per_epoch), scaler)
        st = f2.init_state(seed=SEED)
        st, mt = f2.train_step(st, two_dev)
        lr, eps = mdl.learning_rate, mdl.adam_eps
        res.append((mt.cpu(), [p.grad.cpu() for p in mdl.module.parameters()],
                    [p.detach().cpu() for p in mdl.module.parameters()],
                    [n for n, _ in mdl.module.named_parameters()]))
    (m_g, gr_g, p_g, pnames), (m_c, gr_c, p_c, _) = res
    check_close(f"{label} train step card-vs-CPU metrics", [("metrics", m_g, m_c)])
    def grad_rtol(pname):
        return next((v for k, v in (pooled_rtol or {}).items() if pname.startswith(k)), RTOL)

    check_close(f"{label} train step card-vs-CPU gradients",
                [(f"grad {n}", a, r) for n, a, r in zip(pnames, gr_g, gr_c)], quiet=True,
                rtol={f"grad {n}": grad_rtol(n) for n in pnames})
    if pooled_rtol:
        worst = max(float((a - r).abs().max() / r.abs().max())
                    for n, a, r in zip(pnames, gr_g, gr_c) if grad_rtol(n) != RTOL)
        log(f"  {label} train step card-vs-CPU: the pooled encoders' gradients differ by up to "
            f"{worst:.3e} of their largest (allowed {pooled_rtol}; near-tie winners)")
    # Adam's first step moves each weight by u(g) = -lr g / (|g| + eps). The
    # gradients agree within tau = rtol * max|g|; the weights may then differ
    # by the most u changes when g moves by tau (up to 2 lr where tau covers
    # g's sign, steep where |g| is near eps), on top of RTOL * max|w|.
    undetermined = 0
    for n, a, r, gc in zip(pnames, p_g, p_c, gr_c):
        spread = adam_first_step_spread(gc, grad_rtol(n) * float(gc.abs().max()), lr, eps)
        err = (a.double() - r.double()).abs()
        allowed = RTOL * float(r.abs().max()) + spread
        undetermined += int((spread > RTOL * float(r.abs().max())).sum())
        if bool((err > allowed).any()):
            i = int(torch.argmax(err - allowed))
            fail(f"{label} train step card-vs-CPU parameter {n}: |err| "
                 f"{float(err.flatten()[i]):.3e} > {float(allowed.flatten()[i]):.3e}")
    log(f"  {label} train step card-vs-CPU parameters agree ({undetermined} of "
        f"{sum(p.numel() for p in p_c)} weights have a gradient within tolerance of 0 "
        "or of Adam's eps)")

    # Trainer.fit: 3 epochs, checkpoints every 2, restored by load_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        mdl = full_model(dev)
        trainer = Trainer(mdl, data, gather_cases(data, torch.arange(BATCH)),
                          TrainerConfig(epochs=3, batch_size=BATCH, logs_dir=tmp,
                                        name="smoke", checkpoint_every=2, seed=SEED),
                          loss_scaler=scaler, model_type=model_type)
        trainer.write_model_meta(*points)
        st = trainer.fit()
        log_dir = Path(tmp) / "lightning_logs" / "smoke"
        written = sorted(p.name for p in log_dir.iterdir())
        log(f"  {label} Trainer.fit wrote {written}")
        for fname in ("checkpoint-epoch=2.ckpt", "model.ckpt", "best.ckpt",
                      "model_meta.json"):
            if not (log_dir / fname).exists():
                fail(f"{label} Trainer.fit did not write {fname}")
        restored, epoch = load_checkpoint(log_dir / "model.ckpt", full_model(dev), None,
                                          scaler, steps_per_epoch)
        if epoch != 3 or restored.step != st.step:
            fail(f"{label} load_checkpoint: epoch {epoch}, step {restored.step}")
        for a, b in zip(restored.module.parameters(), st.module.parameters()):
            if not torch.equal(a, b):
                fail(f"{label} load_checkpoint did not restore the trained weights")
        at2, epoch2 = load_checkpoint(log_dir / "checkpoint-epoch=2.ckpt", full_model(dev),
                                      None, scaler, steps_per_epoch)
        if epoch2 != 2 or at2.step != 2 * steps_per_epoch:
            fail(f"{label} checkpoint-epoch=2: epoch {epoch2}, step {at2.step}")
    log(f"  {label} Trainer.fit checkpoints written and restored")
    return {"ms_per_step": ms_step, "steps_per_s": steps_s, "runs_ms_per_step": run_ms,
            "epochs_per_run": epochs, "steps_per_epoch": steps_per_epoch,
            "batch_size": BATCH, "epoch_totals_first_last": [epoch_totals[0],
                                                             epoch_totals[-1]],
            "launches_per_step": per_step, "launches_per_attach": attach_counts,
            "host_syncs_per_step": len(sites)}


def winners(model, batch):
    """Each channel's first maximal row of the pooled feature, (B, F) on the
    host, through the model's own pointnet_global (the kernel on the card)."""
    import torch
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    from porous_cfd_tpu_torch.physics import analytic
    fe = model.module.feature_extract
    with torch.no_grad():
        local = analytic.mlp_value(fe.local_feature.linears, batch["C"],
                                   model.module.activation)
        feats = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        _, arg = pointnet_cuda.pointnet_global(fe.global_feature.linears,
                                               torch.cat([local, feats], dim=-1).contiguous(),
                                               model.module.activation)
    return arg[:, 0].long().cpu()


def agreeing_rows(model, cpu_model, on_card, on_cpu):
    """(B, Ni) mask of the internal rows whose derivatives the card and the
    CPU must share: all but the winner rows (on either side) of a channel
    whose winner differs between the two, a near-tie in the pooled max."""
    import torch
    w_card, w_cpu = winners(model, on_card), winners(cpu_model, on_cpu)
    differ = w_card != w_cpu
    keep = torch.ones((w_card.shape[0], N_INT), dtype=torch.bool)
    for w in (w_card, w_cpu):
        for b, f in differ.nonzero().tolist():
            if w[b, f] < N_INT:
                keep[b, w[b, f]] = False
    log(f"  winners: {int(differ.sum())} of {differ.numel()} channels differ between the "
        f"card and the CPU; {int((~keep).sum())} internal rows left out of the comparison")
    return keep


def first_agreeing_cases(model, cpu_model, data, n=2):
    """The first ``n`` cases of ``data`` whose winners agree on the card and
    the CPU in every channel (a near-tie elsewhere moves a gradient)."""
    import torch
    on_card = data.to(model.device)
    w_card, w_cpu = winners(model, on_card), winners(cpu_model, data)
    same = (w_card == w_cpu).all(dim=-1)
    picked = same.nonzero()[:n, 0].tolist()
    log(f"  winners agree in every channel in {int(same.sum())} of {len(same)} cases; the "
        f"card-vs-CPU step takes cases {picked}")
    if len(picked) < n:
        fail("fewer than two cases whose winners agree on the card and the CPU")
    return tuple(picked)


def check_paths_off_winners(models, batch):
    """On the card: the coupled path's values equal the decoupled ones, and
    J (H) equal the decoupled path's off the internal winner rows, and J the
    exact path's there; the coupling moves J at the winners. The exact
    path's H carries the grad-of-sum mixed term at every row, so its mean
    deviation from the coupled H is reported, not compared."""
    import torch
    from porous_cfd_tpu_torch.train.engine import model_derivatives
    outs = {}
    for key, model in models.items():
        with torch.no_grad():
            outs[key] = [t.detach() for t in model_derivatives(model, batch, True)]
    win = winners(models["coupled"], batch)
    clean = torch.ones((win.shape[0], N_INT), dtype=torch.bool)
    for b in range(win.shape[0]):
        clean[b, win[b][win[b] < N_INT]] = False
    clean = clean.to(batch.data.device)
    ref = outs["coupled"]
    pairs = [("values, decoupled", outs["decoupled"][0], ref[0]),
             ("J off the winners, decoupled", outs["decoupled"][1][clean], ref[1][clean]),
             ("H off the winners, decoupled", outs["decoupled"][2][clean], ref[2][clean])]
    if "exact" in outs:
        pairs += [("values, exact", outs["exact"][0], ref[0]),
                  ("J off the winners, exact", outs["exact"][1][clean], ref[1][clean])]
    check_close("coupled against", pairs)
    moved = float((outs["decoupled"][1][~clean] - ref[1][~clean]).abs().max())
    report = {"winner_rows": int((~clean).sum()), "rows": clean.numel(),
              "j_max_coupling_at_winners": moved}
    if "exact" in outs:
        report["exact_lap_mean_abs_dev"] = float((outs["exact"][2] - ref[2]).abs().mean())
        report["coupled_lap_mean_abs"] = float(ref[2].abs().mean())
    log(f"  {report['winner_rows']} of {report['rows']} internal rows win a channel; the "
        f"coupling moves J there by up to {moved:.3e}" + (
            f"; the exact H differs from the coupled H by {report['exact_lap_mean_abs_dev']:.3e}"
            f" on average (mean |H| {report['coupled_lap_mean_abs']:.3e})"
            if "exact" in outs else ""))
    if not moved > RTOL * float(ref[1].abs().max()):
        fail("the coupling does not move J at the winner rows")
    return report


def manufactured_phase(counters, counts, name, smi):
    """The manufactured-solutions recipe on the card: pipn_manufactured with
    fast_derivatives=True (the coupled path, tanh), 101 epochs of 4 steps
    over 16 cases, the loss at every 25th epoch, then a few steps of the
    default exact path."""
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    from porous_cfd_tpu_torch.models.pipn import pipn_manufactured
    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    dev = torch.device("cuda", 0)
    ds = make_manufactured_batch(np.random.default_rng(SEED), MS_CASES, MS_INT, MS_BND).to(dev)
    steps = MS_CASES // MS_BATCH
    report = {}
    for fast, n_epochs in ((True, MS_EPOCHS), (False, 2)):
        tag = "coupled" if fast else "exact"
        model = pipn_manufactured(0.01, 50.0, 1.0, FE_LOCAL, MS_FE_GLOBAL, SEG,
                                  fast_derivatives=fast,
                                  generator=torch.Generator().manual_seed(SEED), device=dev)
        fns = make_train_functions(model, make_optimizer(model, steps_per_epoch=steps))
        state = fns.init_state(seed=SEED)
        rng = np.random.default_rng(0)
        for c in counters.values():
            c.launches = 0
        losses = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(n_epochs):
            state, m = fns.train_epoch(state, ds, rng.permutation(MS_CASES).reshape(steps,
                                                                                   MS_BATCH))
            if epoch % 25 == 0 or epoch == n_epochs - 1:
                losses[epoch] = float(m[0])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / (n_epochs * steps)
        n_steps = n_epochs * steps
        per_step = {k: c.launches // n_steps for k, c in counters.items()}
        if {k: c.launches for k, c in counters.items()} != {
                k: v * n_steps for k, v in per_step.items()}:
            fail(f"manufactured {tag}: launches not a whole number per step")
        log(f"manufactured {tag}: total loss by epoch {losses}; {ms_step:.3f} ms per step "
            f"(batch {MS_BATCH}, {MS_INT}/{MS_BND} points, with a sync every 25 epochs; "
            f"{name}; {smi}); launches per step {per_step}")
        if not all(np.isfinite(list(losses.values()))):
            fail(f"manufactured {tag}: non-finite loss")
        first, last = losses[0], losses[n_epochs - 1]
        if fast:
            if not last < first:
                fail("manufactured: the total loss did not fall")
            want = counts(pointnet_global=1, pointnet_global_bwd=1, decoder_prop=2,
                          decoder_prop_bwd=2, decoder_prop_j0_add=1, decoder_prop_j0_add_bwd=1)
            log(f"  the loss went from {first:.4f} to {last:.4f} in {n_epochs} epochs "
                f"(the recipe's note expects about 20 to below 1: "
                f"{'held' if first > 10 and last < 1 else 'not held'})")
        else:
            want = counts()
        if per_step != want:
            fail(f"manufactured {tag}: launches per step {per_step} != {want}")
        report[tag] = {"loss_by_epoch": losses, "ms_per_step": ms_step,
                       "steps_per_s": 1e3 / ms_step, "epochs": n_epochs,
                       "steps_per_epoch": steps, "launches_per_step": per_step}
        del state, fns, model
    return report


def cli_phase(name, smi, keep):
    """The port's duct_variable_boundary training CLI on the card, as a user
    runs it: the port's case writer makes a CLI_TRAIN / CLI_VAL variable
    split with the example's data config (cases large enough to sample
    N_INT / N_BND / N_OBS points), then for each of CLI_MODELS the training
    CLI trains CLI_EPOCHS epochs at its default bf16-mixed precision: the
    first as ``python -m porous_cfd_tpu_torch.examples.duct_variable_boundary
    .train --model ...`` in a subprocess, the other in process (``run``; a
    subprocess costs about 20 s of start-up on the card's machine). Checks
    model.ckpt, best.ckpt and model_meta.json, and that
    the training loss fell by CLI_MIN_FALL of itself at least: the trained
    weights against the initial ones (the CLI's seed) on the training
    split, without dropout. Reports ms per epoch (the trainer's, validation
    included), over the whole fit and after its first chunk, which holds
    the start-up. Returns {model: report}. The split and the checkpoints
    stay in the directory ``keep``, ``data/`` and
    ``logs/lightning_logs/<model>/``, for phase 40."""
    import contextlib
    import io
    import re
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.datagen import meta, synthetic_case
    from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as cli
    from porous_cfd_tpu_torch.train.engine import compute_losses
    dev = torch.device("cuda", 0)
    cfg = json.loads((ROOT / "examples" / "duct_variable_boundary" / "assets"
                      / "data_config.json").read_text())
    reports = {}
    keep = Path(keep)
    root = keep / "data"
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=CLI_CASE_POINTS,
                                        n_per_patch=CLI_PATCH_POINTS, variable=True)
        synthetic_case.write_data_config(root / split, cfg["Fields"],
                                         cfg["Variable boundaries"],
                                         cfg["Normalize fields"], cfg["Dims"])
        meta.generate_meta(root / split, *cfg["Fields"], max_dim=len(cfg["Dims"]))
    meta.generate_min_points(root)
    data_s = time.perf_counter() - t0
    for model_type in CLI_MODELS:
        argv = ["--model", model_type, "--epochs", str(CLI_EPOCHS), "--log-every", "10",
                "--n-internal", str(N_INT), "--n-boundary", str(N_BND),
                "--n-observations", str(N_OBS), "--train-dir", str(root / "train"),
                "--val-dir", str(root / "val"), "--logs-dir", str(keep / "logs"),
                "--name", model_type]
        sub = model_type == CLI_MODELS[0]
        cmd = [sys.executable, "-m",
               "porous_cfd_tpu_torch.examples.duct_variable_boundary.train", *argv]
        log(f"cli: {CLI_TRAIN} + {CLI_VAL} cases written in {data_s:.1f} s; running "
            + " ".join(cmd[1:]) + ("" if sub else " (in process)"))
        t0 = time.perf_counter()
        if sub:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"the CLI ({model_type}) exited {proc.returncode}: {proc.stderr[-3000:]}")
            printed = proc.stdout
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.run(argv)
            torch.cuda.synchronize()
            printed = buf.getvalue()
        wall_s = time.perf_counter() - t0
        for line in printed.splitlines():
            log(f"  | {line}")
        log_dir = keep / "logs" / "lightning_logs" / model_type
        for fname in ("model.ckpt", "best.ckpt", "model_meta.json"):
            if not (log_dir / fname).exists():
                fail(f"the CLI ({model_type}) did not write {fname}")
        model_meta = json.loads((log_dir / "model_meta.json").read_text())
        want_meta = {"Model type": model_type, "N internal": N_INT, "N boundary": N_BND,
                     "N observations": N_OBS, "Precision": "bf16-mixed",
                     "Batch size": CLI_TRAIN}
        if model_meta != want_meta:
            fail(f"the CLI's model_meta.json {model_meta} != {want_meta}")
        found = re.search(r"fit: (\d+) epochs in ([0-9.]+) s, ([0-9.]+) ms per epoch; the "
                          r"first (\d+) in ([0-9.]+) s, then ([0-9.]+) ms per epoch",
                          printed)
        if found is None or int(found.group(1)) != CLI_EPOCHS:
            fail(f"the CLI ({model_type}) did not report its fit time")
        ms_epoch, ms_steady = float(found.group(3)), float(found.group(6))
        first_n, first_s = int(found.group(4)), float(found.group(5))
        ckpt = torch.load(log_dir / "model.ckpt", map_location=dev, weights_only=True)
        if ckpt["epoch"] != CLI_EPOCHS or ckpt["step"] != CLI_EPOCHS:
            fail(f"model.ckpt at epoch {ckpt['epoch']}, step {ckpt['step']}")

        # the training loss: initial weights against trained ones on
        # the training split as the CLI sampled it (its rng draws the
        # training cases first), weighted as the CLI weights it,
        # without dropout
        args = cli.build_arg_parser().parse_args(argv)
        train_data = FoamDataset(str(root / "train"), N_INT, N_BND, N_OBS,
                                 rng=np.random.default_rng(cli.SEED))
        model = cli.get_model(args, train_data.normalizers, dev)
        batch = model.attach_neighbors(train_data.stacked().to(dev))
        weights = torch.tensor(cli.get_loss_scaler(args).weights, device=dev)
        totals = []
        for state in (None, ckpt["module"]):
            if state is not None:
                model.module.load_state_dict(state)
            with torch.no_grad():
                losses, _ = compute_losses(model, batch, deterministic=True)
            totals.append(float((weights * losses).sum()))
        fall = (totals[0] - totals[1]) / totals[0]
        log(f"cli: {model_type}, {CLI_EPOCHS} epochs of {CLI_TRAIN} cases at "
            f"{N_INT}/{N_BND}/{N_OBS} points, bf16-mixed validation: {ms_epoch:.3f} ms "
            f"per epoch (the trainer's clock, validation every 10 epochs included); the "
            f"first {first_n} epochs (start-up included) {first_s:.3f} s, then "
            f"{ms_steady:.3f} ms per epoch; {wall_s:.1f} s for the whole command"
            f"{' (a subprocess)' if sub else ''}; "
            f"training loss without dropout {totals[0]:.6f} -> {totals[1]:.6f}, a fall of "
            f"{fall:.3e} of it (at least {CLI_MIN_FALL:.0e} wanted) ({name}; {smi})")
        if not fall >= CLI_MIN_FALL:
            fail(f"cli ({model_type}): the training loss fell by {fall:.3e} of itself, "
                 f"less than {CLI_MIN_FALL:.0e}")
        if model_type == CLI_MODELS[0]:
            reports["inference_evaluate"] = variable_inference_evaluate(
                root, log_dir / "model.ckpt", model, name, smi)
        reports[model_type] = {
            "epochs": CLI_EPOCHS, "train_cases": CLI_TRAIN, "val_cases": CLI_VAL,
            "points": [N_INT, N_BND, N_OBS], "ms_per_epoch": ms_epoch,
            "first_epochs": first_n, "first_epochs_s": first_s,
            "ms_per_epoch_after_first": ms_steady, "command_s": wall_s, "subprocess": sub,
            "data_write_s": data_s, "loss_initial_trained": totals, "loss_fall": fall,
            "model_meta": model_meta}
        del model, batch
        torch.cuda.empty_cache()
    return reports


def check_mrg(model, batch, gen, pk):
    """PIPN++ MRG's five kernel shapes on a real chain of BATCH cases, each
    against its plain version both ways: the three radius levels through
    check_sa_level (branch 1's level 0 and branch 2, static on the chain's
    level 0, branch 2 three layers deep; branch 1's level 1, dynamic and one
    layer deep, on random level-0 features, and again with every seventh
    neighbourhood emptied), the two global levels through check_pointnet at
    their inputs' shapes (branch 3 over every boundary point; branch 4, one
    layer, over branch 1's and branch 2's centroids together). Returns
    {kernel key: {level: numbers}} for both kernels, both directions."""
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    mrg = model.module.global_fe
    nb0, nb1 = extract_sa_neighbors(batch.domain, 2)
    out = {k: {} for k in ("sa_neighborhood", "sa_neighborhood_bwd", "pointnet_global",
                           "pointnet_global_bwd")}
    for key, widths in MRG_SA:
        conv = getattr(mrg, key).conv_mlp
        have = [conv.linears[0].weight.shape[1]] + [lin.weight.shape[0] for lin in conv.linears]
        if have != widths:
            fail(f"mrg {key}: widths {have} != {widths}")
        dynamic = key == "branch1_sa1"
        level = check_sa_level(f"mrg {key}", conv, nb1 if dynamic else nb0,
                               None if dynamic else nb0[5], nb0[0].shape[1] if dynamic else 0,
                               gen, pk, 7 if dynamic else 0)
        for direction, k in (("fwd", "sa_neighborhood"), ("bwd", "sa_neighborhood_bwd")):
            out[k][key] = {"static": not dynamic, **level[direction]}
    rows = {"branch3_gsa": N_BND, "branch4_gsa": nb1[0].shape[1] + nb0[0].shape[1]}
    for key, widths in MRG_GLOBAL:
        fwd, bwd = check_pointnet(widths, rows[key], True, gen, f"mrg {key}")
        shape = {"input": [BATCH, rows[key], widths[0]], "widths": widths}
        out["pointnet_global"][key] = {**shape, **shape_timing(fwd, pk)}
        out["pointnet_global_bwd"][key] = {**shape, **shape_timing(bwd, pk),
                                           "winner_rows": bwd["winner_rows"]}
    return out


def fixed_cli_phase(name, smi, counters, keep):
    """The port's duct_fixed_boundary experiment on the card, through the
    entry points a user calls: the port's FVM solver writes FIX_TRAIN +
    FIX_VAL golden-duct cases at FIX_GRID with their meta; for each of
    FIX_MODELS the training CLI (``examples/duct_fixed_boundary/train.py``,
    ``run``) trains FIX_EPOCHS epochs at the golden points, bf16-mixed
    validation; checks model.ckpt, best.ckpt and model_meta.json, the launch
    counts of the whole command, and that the training loss without dropout
    fell by FIX_MIN_FALL of itself at least (the trained weights against the
    CLI's initial ones on the training split); the inference CLI
    (``load_model_and_params`` and ``predict``, f32) restores the checkpoint
    and predicts each held-out case as the trained model predicts the split,
    within RTOL; the evaluate CLI prints finite errors and pressure drops.
    The data and the checkpoints stay in the directory ``keep``, ``data/``
    and ``logs/lightning_logs/<model>/``, for phases 38 and 40."""
    import contextlib
    import io
    import re
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate, inference, train
    from porous_cfd_tpu_torch.tools.train_golden_duct import TRAIN_CASES, VAL_CASES, generate
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_predict_functions)
    dev = torch.device("cuda", 0)
    n_int, n_bnd, n_obs = FIX_POINTS
    points = ["--n-internal", str(n_int), "--n-boundary", str(n_bnd),
              "--n-observations", str(n_obs)]
    report = {"grid": list(FIX_GRID), "train_cases": FIX_TRAIN, "val_cases": FIX_VAL,
              "points": list(FIX_POINTS), "epochs": FIX_EPOCHS}
    keep = Path(keep)
    root = keep / "data"
    t0 = time.perf_counter()
    report["solve_s_per_split"] = generate(root, *FIX_GRID, TRAIN_CASES[:FIX_TRAIN],
                                           VAL_CASES[:FIX_VAL])
    report["solve_s"] = time.perf_counter() - t0
    log(f"fixed cli: {FIX_TRAIN} + {FIX_VAL} golden-duct cases solved by the port's FVM "
        f"solver and written at {FIX_GRID[0]}x{FIX_GRID[1]} in {report['solve_s']:.1f} s "
        f"(cut from the golden run's 13 + 4 cases for this script's time; grid, points "
        f"and model widths are the golden run's)")
    split_args = ["--train-dir", str(root / "train"), "--val-dir", str(root / "val")]
    held_out = ["--data-dir", str(root / "val"), "--meta-dir", str(root / "train")]
    for model_type in FIX_MODELS:
        argv = ["--model", model_type, "--epochs", str(FIX_EPOCHS), "--log-every", "10",
                "--batch-size", str(FIX_TRAIN), *points, *split_args,
                "--logs-dir", str(keep / "logs"), "--name", model_type]
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            model = train.run(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        want = ({"pointnet_global", "decoder_prop"} if model_type == "pipn" else
                {"sa_neighborhood", "pointnet_global", "farthest_point_sampling"}
                | ({"decoder_prop"} if model_type != "pipn-pp-full" else set()))
        backward = "sa_neighborhood_bwd" if model_type == "pipn-pp-full" else \
            "decoder_prop_bwd"
        if not want <= {k for k in launches if not k.endswith("_bwd")} or \
                backward not in launches:
            fail(f"fixed cli {model_type}: launches {launches} lack a kernel of {want}")
        log_dir = keep / "logs" / "lightning_logs" / model_type
        for fname in ("model.ckpt", "best.ckpt", "model_meta.json"):
            if not (log_dir / fname).exists():
                fail(f"fixed cli {model_type}: the CLI did not write {fname}")
        model_meta = json.loads((log_dir / "model_meta.json").read_text())
        if model_meta["Model type"] != model_type or model_meta["N boundary"] != n_bnd:
            fail(f"fixed cli {model_type}: model_meta.json {model_meta}")
        found = re.search(r"fit: \d+ epochs in ([0-9.]+) s, ([0-9.]+) ms per epoch; the "
                          r"first (\d+) in ([0-9.]+) s, then ([0-9.]+) ms per epoch",
                          printed.getvalue())
        if found is None:
            fail(f"fixed cli {model_type}: the CLI did not report its fit time")
        ms_epoch, ms_steady = float(found.group(2)), float(found.group(5))

        # the training loss without dropout: the CLI's initial weights
        # against the trained module, on the training split as the CLI
        # sampled it (its rng draws the training cases first)
        args = train.build_arg_parser().parse_args(argv)
        train_data = FoamDataset(str(root / "train"), n_int, n_bnd, n_obs,
                                 rng=np.random.default_rng(train.SEED))
        weights = torch.tensor(train.get_loss_scaler(args).weights, device=dev)
        totals = []
        for mdl in (train.get_model(args, train_data.normalizers, dev), model):
            batch = mdl.attach_neighbors(train_data.stacked().to(dev))
            with torch.no_grad():
                losses, _ = compute_losses(mdl, batch, deterministic=True)
            totals.append(float((weights * losses).sum()))
        fall = (totals[0] - totals[1]) / totals[0]
        if not fall >= FIX_MIN_FALL:
            fail(f"fixed cli {model_type}: the training loss fell by {fall:.3e} of itself, "
                 f"less than {FIX_MIN_FALL:.0e}")

        # inference: the checkpoint restored, each held-out case alone
        # in f32, against the trained model on the whole split
        inf_argv = ["--checkpoint", str(log_dir / "model.ckpt"), *held_out, *points]
        preds = inference.run(inf_argv + ["--precision", "32-true"])
        val_data = FoamDataset(str(root / "val"), n_int, n_bnd, n_obs,
                               np.random.default_rng(train.SEED), str(root / "train"))
        stacked = model.attach_neighbors(val_data.stacked().to(dev))
        ref = make_predict_functions(model).predict_batch(
            gather_cases(stacked, torch.arange(len(val_data), device=dev))).data.cpu()
        err_inf = check_close(f"fixed cli {model_type} inference against the trained model",
                              [(f"case {i}", torch.as_tensor(p_.data), ref[i])
                               for i, p_ in enumerate(preds)])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = evaluate.run(inf_argv)
        log(f"  | {printed.getvalue().strip()}")
        if not finite_numbers(summary):
            fail(f"fixed cli {model_type}: evaluate printed a non-finite number {summary}")
        log(f"fixed cli {model_type}: {FIX_EPOCHS} epochs of {FIX_TRAIN} cases at "
            f"{n_int}/{n_bnd}/{n_obs} points in {wall_s:.1f} s for the whole command, "
            f"{ms_epoch:.3f} ms per epoch (the trainer's clock, bf16-mixed validation every "
            f"10 epochs included), {ms_steady:.3f} after the first chunk; training loss "
            f"without dropout {totals[0]:.6f} -> {totals[1]:.6f}, a fall of {fall:.3e} of "
            f"it; inference within {err_inf:.3e} of the trained model; evaluate "
            f"{json.dumps(summary)} ({name}; {smi})")
        report[model_type] = {"command_s": wall_s, "ms_per_epoch": ms_epoch,
                              "ms_per_epoch_after_first": ms_steady,
                              "launches": launches, "loss_initial_trained": totals,
                              "loss_fall": fall, "inference_max_abs_err": err_inf,
                              "evaluate": summary, "model_meta": model_meta}
        del model
        torch.cuda.empty_cache()
    return report


def variable_inference_evaluate(root, ckpt, model, name, smi):
    """Phase 15's checkpoint through the duct_variable_boundary inference
    CLI (in process: each held-out case alone in f32 against ``model``, the
    checkpoint's weights, on the whole split, within RTOL) and its evaluate
    CLI (in process too: the printed line parses and its numbers are
    finite)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.examples.duct_variable_boundary import evaluate, inference, train
    from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
    dev = torch.device("cuda", 0)
    argv = ["--checkpoint", str(ckpt), "--data-dir", str(root / "val"), "--meta-dir",
            str(root / "train"), "--n-internal", str(N_INT), "--n-boundary", str(N_BND),
            "--n-observations", str(N_OBS)]
    preds = inference.run(argv + ["--precision", "32-true"])
    val_data = FoamDataset(str(root / "val"), N_INT, N_BND, N_OBS,
                           np.random.default_rng(train.SEED), str(root / "train"))
    stacked = model.attach_neighbors(val_data.stacked().to(dev))
    ref = make_predict_functions(model).predict_batch(
        gather_cases(stacked, torch.arange(len(val_data), device=dev))).data.cpu()
    err_inf = check_close("variable inference against the checkpoint's weights",
                          [(f"case {i}", torch.as_tensor(p_.data), ref[i])
                           for i, p_ in enumerate(preds)])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        evaluate.run(argv)
    wall_s = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not finite_numbers(summary) or summary["cases"] != len(val_data):
        fail(f"the variable evaluate CLI printed {summary}")
    log(f"cli: the variable inference CLI within {err_inf:.3e} of the checkpoint's weights; "
        f"evaluate ({wall_s:.1f} s) {json.dumps(summary)} ({name}; {smi})")
    return {"inference_max_abs_err": err_inf, "evaluate": summary, "evaluate_command_s": wall_s}


def bench_phase(name, smi):
    """``python -m porous_cfd_tpu_torch.bench`` at the envelope with
    BENCH_RUNS runs of BENCH_EPOCHS epochs: its line parses, and every
    family, the two U-Nets among them, has a steps/s number."""
    from porous_cfd_tpu_torch import bench
    cmd = [sys.executable, "-m", "porous_cfd_tpu_torch.bench", "--runs", str(BENCH_RUNS),
           "--epochs", str(BENCH_EPOCHS)]
    log("bench: running " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if len(bench.FAMILIES) != 10 or list(line["families"]) != list(bench.FAMILIES):
        fail(f"bench: its families {list(line['families'])} are not the ten of bench.py")
    for family in bench.FAMILIES:
        got = line["families"][family]
        if not (isinstance(got, float) and got > 0):
            fail(f"bench: {family} has no steps/s number ({got!r})")
    if line["card"] != smi:
        fail(f"bench: its card {line['card']!r} is not {smi!r}")
    log(f"bench: {wall_s:.1f} s; steps/s "
        + ", ".join(f"{k} {v:.2f}" for k, v in line["families"].items())
        + f" ({line['timing']}; {name}; {smi})")
    return {"command_s": wall_s, "line": line}


def pointnet_backward_turns(gen):
    """pointnet_global's backward (the winner-row kernel, through
    ``pointnet_global_backward``) at the ++ global levels, PN_PP_LEVELS,
    timed in PN_TURNS turns (each turn times every level once, with CUDA
    events) so that a level's spread across turns shows the card's own
    drift. Returns {level: {"turns_ms": [...], ...}}."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    dev = torch.device("cuda", 0)
    calls = {}
    for label, widths, rows in PN_PP_LEVELS:
        act = "tanh" if "manufactured" in label else "silu"
        mlp = MLP(widths, activation=act, generator=gen).to(dev)
        x = torch.randn((BATCH, rows, widths[0]), generator=gen).to(dev)
        w = [lin.weight.detach() for lin in mlp.linears]
        b = [lin.bias.detach() for lin in mlp.linears]
        with torch.no_grad():
            _, arg = pointnet_cuda.pointnet_global(mlp.linears, x, act)
        dm = torch.randn((BATCH, 1, widths[-1]), generator=gen).to(dev)
        calls[label] = (lambda w=w, b=b, x=x, act=act, arg=arg.contiguous(), dm=dm:
                        pointnet_cuda.pointnet_global_backward(w, b, x, act, arg, dm, True))
    out = {label: {"widths": widths, "rows": rows, "turns_ms": []}
           for label, widths, rows in PN_PP_LEVELS}
    for _ in range(PN_TURNS):
        for label, fn in calls.items():
            out[label]["turns_ms"].append(time_ms(torch, fn))
    for label, r in out.items():
        r["spread_ms"] = max(r["turns_ms"]) - min(r["turns_ms"])
        log(f"  pointnet_global backward {label} {r['widths']} over {r['rows']} rows, in "
            f"turns: " + ", ".join(f"{t:.4f}" for t in r["turns_ms"]) + " ms")
    return out


def check_manufactured_pp(model, data, gen, pk):
    """Phase 3m: the manufactured PIPN++'s kernel shapes on a real chain of
    BATCH cases of ``data`` (make_manufactured_batch, MSP_INT / MSP_BND
    points), all at tanh, each against its plain version both ways: SA level
    0 static and one layer ([6, 64], from the chain's [boundaryId || C]
    rows), SA level 1 dynamic and one layer ([66, 128], on random level-0
    features, and again with every seventh neighbourhood emptied), FPS at
    both levels over every case's boundary cloud and over one case's
    (indices equal), pointnet_global one layer [130, 1024] over the 25
    level-1 centroids with dx, and the decoupled decoder MSP_SEG with no
    dropout over MSP_INT + MSP_BND rows; blocks per SM at each SA level and
    pointnet's blocks. Returns {kernel key: numbers at these shapes}."""
    import torch
    from porous_cfd_tpu_torch.models.neighbors import fps_count
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    from porous_cfd_tpu_torch.train.engine import gather_cases
    dev = torch.device("cuda", 0)
    seq = model.module.feature_extract.global_feature
    have = [[m.linears[0].weight.shape[1]] + [lin.weight.shape[0] for lin in m.linears]
            for m in (seq.sa_0.conv_mlp, seq.sa_1.conv_mlp, seq.global_sa.mlp)]
    if have != MSP_GLOBAL or model.module.activation != "tanh":
        fail(f"manufactured pipn_pp: widths {have}, activation {model.module.activation}")
    n_pts = [MSP_BND]
    for f in MSP_FRACTION:
        n_pts.append(fps_count(n_pts[-1], f))
    blocks = {}
    for i, static in ((0, True), (1, False)):
        blk = sa_blocks_at(MSP_GLOBAL[i], n_pts[i + 1], MSP_NEIGHBORS, n_pts[i], static)
        blocks[f"sa level {i}"] = blk
        log(f"  blocks sa_neighborhood manufactured level {i} {MSP_GLOBAL[i]}, {n_pts[i + 1]} "
            f"centroids of {MSP_NEIGHBORS}: " + ", ".join(f"{k} {v}" for k, v in blk.items()))
        if min(blk["fwd_blocks_per_sm"], blk["bwd_blocks_per_sm"]) < 1:
            fail(f"sa_neighborhood manufactured level {i}: no block fits an SM ({blk})")
    cols, pts, fwd_b, bwd_b = pointnet_cuda.blocks(MSP_GLOBAL[-1])
    blocks["pointnet"] = {"columns": cols, "points": pts, "fwd_smem": fwd_b, "bwd_smem": bwd_b}
    log(f"  blocks pointnet_global manufactured global {MSP_GLOBAL[-1]}: forward {pts} "
        f"points, two warpgroups of {cols} columns each, {fwd_b} bytes of shared memory; "
        f"backward {bwd_b} bytes")
    chain = model.neighbor_precompute(gather_cases(data, torch.arange(BATCH)).to(dev))
    sa_fwd, sa_bwd = check_sa(seq, chain, gen, pk, len(MSP_RADIUS), act="tanh")
    pos = data.data[:, MSP_INT:, data.column_indices("C")].contiguous().to(dev)
    fps = fps_levels(torch, pos, n_pts[1:], f"manufactured B={pos.shape[0]}")
    fps_one = fps_levels(torch, pos[:1].contiguous(), n_pts[1:], "manufactured B=1")
    pn_fwd, pn_bwd = check_pointnet(MSP_GLOBAL[-1], n_pts[-1], True, gen,
                                    "pipn_pp manufactured global", act="tanh")
    dec_fwd, dec_bwd = check_decoder(MSP_SEG, None, gen, "pipn_pp manufactured", act="tanh",
                                     n_int=MSP_INT, n_bnd=MSP_BND)
    split_backward(torch, dec_bwd, grad_shapes(*[[MSP_LOCAL[-1]] + MSP_SEG[1:]] * 2,
                                               n_int=MSP_INT, n_bnd=MSP_BND), pk)
    turns = pointnet_backward_turns(gen)
    fps_numbers = {k: fps[k] for k in ("ms", "device_ms", "plain_ms", "flops", "nbytes")}
    out = {}
    for key, res, shape in (
            ("sa_neighborhood", sa_fwd, {"widths": MSP_GLOBAL[:2], "activation": "tanh"}),
            ("sa_neighborhood_bwd", sa_bwd, {"widths": MSP_GLOBAL[:2], "activation": "tanh"}),
            ("pointnet_global", pn_fwd, {"input": [BATCH, n_pts[-1], MSP_GLOBAL[-1][0]],
                                         "widths": MSP_GLOBAL[-1], "activation": "tanh"}),
            ("pointnet_global_bwd", pn_bwd, {"input": [BATCH, n_pts[-1], MSP_GLOBAL[-1][0]],
                                             "widths": MSP_GLOBAL[-1], "activation": "tanh",
                                             "winner_rows": pn_bwd["winner_rows"],
                                             "pp_global_levels_in_turns": turns}),
            ("decoder_prop", dec_fwd, {"widths": MSP_SEG, "activation": "tanh",
                                       "points": [MSP_INT, MSP_BND]}),
            ("decoder_prop_bwd", dec_bwd, {"widths": MSP_SEG, "activation": "tanh",
                                           "points": [MSP_INT, MSP_BND]}),
            ("farthest_point_sampling", {**fps_numbers, "err": 0.0},
             {"levels": fps["levels"], "at_b1": fps_one["levels"]})):
        out[key] = {**shape, **shape_timing(res, pk), **res.get("extra", {})}
    out["sa_neighborhood"]["blocks"] = blocks
    return out


def manufactured_cli_phase(name, smi, counters):
    """Phase 22: the port's manufactured_solutions experiment on the card,
    through the entry points a user calls: ``generate_data`` writes its
    16 / 4 / 4 split into a temporary directory; the training CLI trains
    ``pipn-pp`` (its analytic path, the four kernels) and ``pipn`` (the
    exact operator, no kernel) for MS_CLI_EPOCHS epochs at MS_CLI_POINTS
    points; checks model.ckpt, best.ckpt and model_meta.json, the launches
    of each command, and that the loss without dropout fell (the trained
    weights against the CLI's initial ones on the training split); the
    inference CLI restores each checkpoint and predicts each held-out case
    as the trained model does, within RTOL; the evaluate CLI prints finite
    errors."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.examples.manufactured_solutions import (evaluate, generate_data,
                                                                      inference, train)
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_predict_functions)
    dev = torch.device("cuda", 0)
    n_int, n_bnd = MS_CLI_POINTS
    points = ["--n-internal", str(n_int), "--n-boundary", str(n_bnd), "--n-observations", "0"]
    report = {"splits": dict(generate_data.SPLITS), "points": list(MS_CLI_POINTS),
              "epochs": MS_CLI_EPOCHS, "batch_size": MS_CLI_BATCH}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        t0 = time.perf_counter()
        generate_data.run(str(root))
        log(f"manufactured cli: generate_data wrote {generate_data.SPLITS} cases in "
            f"{time.perf_counter() - t0:.2f} s")
        held_out = ["--data-dir", str(root / "val"), "--meta-dir", str(root / "train")]
        for model_type in ("pipn-pp", "pipn"):
            argv = ["--model", model_type, "--epochs", str(MS_CLI_EPOCHS), "--log-every", "10",
                    "--batch-size", str(MS_CLI_BATCH), *points,
                    "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
                    "--logs-dir", str(Path(tmp) / "logs"), "--name", model_type]
            for c in counters.values():
                c.launches = 0
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                model = train.run(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            for line in printed.getvalue().splitlines():
                log(f"  | {line}")
            if model_type == "pipn-pp":
                want = {"sa_neighborhood", "sa_neighborhood_bwd", "pointnet_global",
                        "pointnet_global_bwd", "decoder_prop", "decoder_prop_bwd",
                        "farthest_point_sampling"}
                if set(launches) != want:
                    fail(f"manufactured cli pipn-pp: launches {launches}, not of {want}")
            elif launches:
                fail(f"manufactured cli pipn (the exact operator) launched {launches}")
            log_dir = Path(tmp) / "logs" / "lightning_logs" / model_type
            for fname in ("model.ckpt", "best.ckpt", "model_meta.json"):
                if not (log_dir / fname).exists():
                    fail(f"manufactured cli {model_type}: the CLI did not write {fname}")
            model_meta = json.loads((log_dir / "model_meta.json").read_text())
            if model_meta["Model type"] != model_type or model_meta["N boundary"] != n_bnd:
                fail(f"manufactured cli {model_type}: model_meta.json {model_meta}")
            # the loss without dropout, the CLI's initial weights against the
            # trained module on the training split as the CLI sampled it
            args = train.build_arg_parser().parse_args(argv)
            train_data = train.make_datasets(args)[0]
            totals = []
            for mdl in (train.get_model(model_type, device=dev), model):
                batch = mdl.attach_neighbors(train_data.stacked().to(dev))
                with torch.enable_grad() if mdl.derivative_apply is None else torch.no_grad():
                    losses, _ = compute_losses(mdl, batch, deterministic=True)
                totals.append(float(losses.detach().sum()))
            if not totals[1] < totals[0]:
                fail(f"manufactured cli {model_type}: the training loss did not fall {totals}")
            inf_argv = ["--checkpoint", str(log_dir / "model.ckpt"), *held_out, *points[:4]]
            preds = inference.run(inf_argv + ["--precision", "32-true"])
            val_data = inference.load_split(inference.build_arg_parser().parse_args(inf_argv))
            stacked = model.attach_neighbors(val_data.stacked().to(dev))
            ref = make_predict_functions(model).predict_batch(
                gather_cases(stacked, torch.arange(len(val_data), device=dev))).data.cpu()
            err_inf = check_close(f"manufactured cli {model_type} inference against the "
                                  "trained model",
                                  [(f"case {i}", torch.as_tensor(p_.data), ref[i])
                                   for i, p_ in enumerate(preds)])
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                summary = evaluate.run(inf_argv)
            log(f"  | {printed.getvalue().strip()}")
            if not finite_numbers(summary):
                fail(f"manufactured cli {model_type}: evaluate printed a non-finite number "
                     f"{summary}")
            log(f"manufactured cli {model_type}: {MS_CLI_EPOCHS} epochs in {wall_s:.1f} s for "
                f"the whole command; loss without dropout {totals[0]:.6f} -> {totals[1]:.6f}; "
                f"inference within {err_inf:.3e} of the trained model; launches {launches}; "
                f"evaluate {json.dumps(summary)} ({name}; {smi})")
            report[model_type] = {"command_s": wall_s, "launches": launches,
                                  "loss_initial_trained": totals,
                                  "inference_max_abs_err": err_inf, "evaluate": summary,
                                  "model_meta": model_meta}
            del model
            torch.cuda.empty_cache()
    return report


def exact_paths_phase(families, data, counters, name, smi):
    """Phase 23: the exact autodiff paths on the card. For each family of
    ``families`` ({label: factory(device, fast)}): the exact path
    (``fast_derivatives=False``) and the analytic path, same weights, same
    seed, dropout on, over BATCH cases: values, J and H equal within RTOL
    (each of these families' analytic path is exact: its pooled context
    does not depend on the differentiated coordinates); one training step
    of each path from the same weights over EXACT_CASES cases, dropout on:
    the loss vector and the gradients of every parameter outside the pooled
    encoders (POOLED_PARAMS) equal within RTOL, the encoders' largest
    difference logged beside their largest gradient; then EXACT_STEPS
    training steps of the exact path, no kernel launched in a step, and the
    loss without dropout falling over them."""
    import torch
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_optimizer, make_train_functions,
                                                   model_derivatives)
    dev = torch.device("cuda", 0)
    scaler = FixedLossScaler(LOSS_WEIGHTS)
    weights = torch.tensor(LOSS_WEIGHTS, dtype=torch.float32, device=dev)
    report = {}
    for label, factory in families.items():
        fast, exact = factory(dev, True), factory(dev, False)
        if exact.derivative_apply is not None:
            fail(f"exact {label}: fast_derivatives=False kept an analytic path")
        batch = fast.attach_neighbors(gather_cases(data, torch.arange(BATCH)).to(dev))
        with torch.no_grad():
            ref = model_derivatives(fast, batch, False, seed=SEED)
        got = [t.detach() for t in model_derivatives(exact, batch, False, seed=SEED)]
        err = check_close(f"exact {label} against its analytic path, dropout on",
                          list(zip(("values", "J", "H"), got, ref)))
        del ref, got
        train_batch = gather_cases(batch, torch.arange(EXACT_CASES, device=dev))
        stepped = []
        for mdl in (fast, exact):
            f1 = make_train_functions(mdl, make_optimizer(mdl, 1), scaler)
            _, m1 = f1.train_step(f1.init_state(seed=SEED), train_batch)
            stepped.append((m1, [p.grad.detach().clone() for p in mdl.module.parameters()]))
        names = [n for n, _ in exact.module.named_parameters()]
        grads = list(zip(names, stepped[1][1], stepped[0][1]))
        err_step = check_close(f"exact {label} one step against its analytic path",
                               [("metrics", stepped[1][0], stepped[0][0])]
                               + [(f"grad {n}", a, r) for n, a, r in grads
                                  if not n.startswith(POOLED_PARAMS)], quiet=True)
        pooled = [(float((a - r).abs().max()), float(r.abs().max())) for n, a, r in grads
                  if n.startswith(POOLED_PARAMS)]
        pooled_err = max(pooled, default=(0.0, 0.0))
        log(f"  exact {label}: the pooled encoders' gradients ({len(pooled)} tensors) differ "
            f"by up to {pooled_err[0]:.3e} (largest gradient there {pooled_err[1]:.3e}; "
            f"near-tie winners, not gated)")
        del stepped, grads
        exact = factory(dev, False)

        def loss_now():
            with torch.enable_grad():
                losses, _ = compute_losses(exact, train_batch, deterministic=True)
            return float((weights * losses.detach()).sum())

        before = loss_now()
        fns = make_train_functions(exact, make_optimizer(exact, 1), scaler)
        state = fns.init_state(seed=SEED)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals = []
        for _ in range(EXACT_STEPS):
            state, m = fns.train_step(state, train_batch)
            totals.append(m[0])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / EXACT_STEPS
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        totals = [float(t) for t in totals]
        after = loss_now()
        log(f"exact {label}: {EXACT_STEPS} steps over {EXACT_CASES} cases, total loss with "
            f"dropout {totals[0]:.6f} -> {totals[-1]:.6f}, without {before:.6f} -> "
            f"{after:.6f}; {ms_step:.2f} ms a step with a sync each (the host's clock); "
            f"launches {launches} ({name}; {smi})")
        if launches:
            fail(f"exact {label}: the exact path launched {launches}")
        if not all(t == t and abs(t) < float("inf") for t in totals) or not after < before:
            fail(f"exact {label}: the loss is not finite or did not fall")
        report[label] = {"max_abs_err_against_analytic": err,
                         "step_max_abs_err_against_analytic": err_step,
                         "step_pooled_grad_max_abs_diff": pooled_err[0],
                         "loss_with_dropout": totals,
                         "loss_without_dropout_before_after": [before, after],
                         "ms_per_step": ms_step}
        del fast, exact, fns, state, batch, train_batch
        torch.cuda.empty_cache()
    return report


def check_unet(models, data, gen, pk):
    """Phase 3n: the U-Nets' kernel shapes on a real all-points chain of
    ``data``'s clouds ([internal || boundary], 2,500 points a case), each
    against its plain version both ways: FPS 2500 -> 1250 (design B, the
    clusters, on every case) -> 313 (design A); for each of ``models``
    ({label: model on the card}) its SA levels 0 ([9, 64, 64, 128] over
    the 2,500 points, 1250 centroids) and 1 ([130, 128, 128, 256], 313
    centroids), both dynamic, 64 neighbours, on the chain of BATCH cases,
    and its one-layer global level through pointnet_global over the 313
    centroids with dx; and PI-GANO++ full's branch [8, 128, 256, 256, 256]
    over its 1,750 rows. Returns {kernel key: {shape label: numbers}}."""
    import torch
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors, fps_count
    from porous_cfd_tpu_torch.train.engine import gather_cases
    dev = torch.device("cuda", 0)
    internal, boundary = split_contiguous(data)
    pts = torch.cat([internal["C"], boundary["C"]], dim=-2).contiguous().to(dev)
    n_pts = pts.shape[1]
    fraction = next(iter(models.values())).module.encoder.fraction
    levels = [fps_count(n_pts, fraction[0])]
    levels.append(fps_count(levels[0], fraction[1]))
    fps = fps_levels(torch, pts, levels, f"U-Net all points B={N_CASES}")
    if fps["levels"]["level_0"]["design"]["kind"] != "B":
        fail(f"FPS over {n_pts} points did not take design B")
    b_fps = bound(fps["flops"], fps["nbytes"], *pk)
    out = {"farthest_point_sampling": {"U-Net all points": {
        "input": [N_CASES, n_pts, 2], "samples": levels, "ms": fps["ms"],
        "device_ms": fps["device_ms"], "plain_ms": fps["plain_ms"], "bound_ms": b_fps[0],
        "bound_by": b_fps[1], "bound_f32_core_ms": b_fps[2], "flop": fps["flops"],
        "bytes": fps["nbytes"], "max_abs_err": 0.0, "levels": fps["levels"]}}}
    for key in ("sa_neighborhood", "pointnet_global"):
        out[key], out[f"{key}_bwd"] = {}, {}
    for label, model in models.items():
        chain = model.neighbor_precompute(gather_cases(data, torch.arange(BATCH)).to(dev))
        nbrs = extract_sa_neighbors(chain, 2)
        enc = model.module.encoder
        for i, n_src in enumerate((n_pts, levels[0])):
            res = check_sa_level(f"{label} level {i} dynamic", getattr(enc, f"sa_{i}").conv_mlp,
                                 nbrs[i], None, n_src, gen, pk)
            out["sa_neighborhood"][f"{label} level {i}"] = res["fwd"]
            out["sa_neighborhood_bwd"][f"{label} level {i}"] = res["bwd"]
        widths = list(enc.global_sa.mlp.layers)
        pn = check_pointnet(widths, levels[1], True, gen, f"{label} global")
        for i, key in enumerate(("pointnet_global", "pointnet_global_bwd")):
            out[key][f"{label} global"] = {"input": [BATCH, levels[1], widths[0]],
                                           "widths": widths, **shape_timing(pn[i], pk),
                                           **({"winner_rows": pn[i]["winner_rows"]}
                                              if "winner_rows" in pn[i] else {})}
    branch = list(models["pi-gano-pp-full"].module.branch.linear.layers)
    pn = check_pointnet(branch, PG_N_BRANCH, False, gen, "pi-gano-pp-full branch")
    for i, key in enumerate(("pointnet_global", "pointnet_global_bwd")):
        out[key]["pi-gano-pp-full branch"] = {"input": [BATCH, PG_N_BRANCH, branch[0]],
                                              "widths": branch, **shape_timing(pn[i], pk),
                                              **({"winner_rows": pn[i]["winner_rows"]}
                                                 if "winner_rows" in pn[i] else {})}
    return out


def frozen_hierarchy(model, batch, seed):
    """The function the U-Nets' analytic path differentiates, on the card in
    plain PyTorch: the last FP level (its kNN interpolation, the skip rows
    ``[sdf || boundaryId || C]``, its MLP with the step's dropout masks and,
    for PI-GANO++ full, the branch's scale) as a function of the internal
    points' own coordinates, every coarser level held at its value (the
    hierarchy through the kernels, no gradient). Returns its (out, J, H)
    by the exact operator ``pinn_derivatives``."""
    import torch
    from porous_cfd_tpu_torch.models import fp_analytic
    from porous_cfd_tpu_torch.models.pi_gano import PiGanoPpFullModule, gather_parameters
    from porous_cfd_tpu_torch.models.pipn import _pointnet_global_dispatch
    from porous_cfd_tpu_torch.models.set_abstraction import fp_level_seed
    from porous_cfd_tpu_torch.physics.operators import pinn_derivatives
    module = model.module
    par = None
    with torch.no_grad():
        if isinstance(module, PiGanoPpFullModule):
            par = _pointnet_global_dispatch(module.branch.linear,
                                            gather_parameters(batch,
                                                              module.variable_boundaries),
                                            module.activation)
        x, pos, idx, x_in, pts, n_int = fp_analytic.hierarchy(module, batch, None, par)
    last = module.decoder.levels[-1]
    n_fp = len(module.decoder.fp_layers)

    def apply_fn(p_int):
        pts_all = torch.cat([p_int, pts[:, n_int:]], dim=-2)
        x_skip = torch.cat([x_in[..., :-pts.shape[-1]], pts_all], dim=-1)
        y = last.mlp(last.upsample(x, pos, x_skip, pts_all, idx), False,
                     fp_level_seed(seed, n_fp - 1))
        return y if par is None else y * last.modulation(par)

    return pinn_derivatives(apply_fn, pts[:, :n_int])


def running_max_forward(sa, chunks):
    """``sa``'s forward (a SetAbstraction on a precomputed level) as the JAX
    module computes it with ``k_chunks=chunks``: the shared MLP and the
    masked max over each chunk of the neighbours in turn, folded by a
    running max. The port takes one max over all of them; phase 28 sets this
    forward on the encoder's levels to compare the two's memory."""
    import torch
    from porous_cfd_tpu_torch.models.neighbors import gather_points

    def forward(x, pos, deterministic=True, neighbors=None):
        cent, idx, mask = neighbors[:3]
        pos_c = gather_points(pos, cent)
        step = idx.shape[-1] // chunks
        out = None
        for sl in (slice(c, c + step) for c in range(0, idx.shape[-1], step)):
            rel = (gather_points(pos, idx[..., sl]) - pos_c[..., None, :]) / sa.r
            h = sa.conv_mlp(torch.cat([gather_points(x, idx[..., sl]), rel], dim=-1),
                            deterministic)
            m = torch.max(h.masked_fill(~mask[..., sl, None], torch.finfo(h.dtype).min),
                          dim=-2).values
            out = m if out is None else torch.maximum(out, m)
        return out.masked_fill(~mask.any(dim=-1)[..., None], 0.0), pos_c

    return forward


def unet_exact_phase(families, data, counters, name, smi):
    """Phase 28: the U-Nets' exact paths on the card (``fast_derivatives=
    False``: micro-batches of 2). For each of ``families`` ({label:
    factory(device, fast)}), over EXACT_CASES cases, dropout on, one seed:
    on 2 of them, the exact path's values equal the analytic path's within
    RTOL (both paths drop the same columns); the analytic path's J and H
    equal, on
    every internal row, autodiff of the frozen hierarchy
    (``frozen_hierarchy``: the function its decoupling defines, held as
    ``tests/test_fp_analytic.py:107-211`` holds it), J within RTOL, H
    within UNET_H_RTOL; the exact path's own J and H also carry the coarse
    features' dependence on each point, so only their difference is
    logged. Then, after a warm-up step, three training steps from the same
    weights, each with its peak device memory (max_memory_allocated) and
    time: the exact path as built; with its SA levels' max taken over
    UNET_K_CHUNKS chunks by a running max (the JAX module's ``k_chunks``,
    ``running_max_forward``), its metrics and gradients equal to the first's
    within RTOL; and in micro-batches of 1. Then UNET_EXACT_STEPS steps, no
    kernel launched, the loss without dropout falling over them."""
    import dataclasses
    import torch
    from porous_cfd_tpu_torch.models.set_abstraction import SetAbstraction
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_optimizer, make_train_functions,
                                                   model_derivatives)
    dev = torch.device("cuda", 0)
    scaler = FixedLossScaler(LOSS_WEIGHTS)
    weights = torch.tensor(LOSS_WEIGHTS, dtype=torch.float32, device=dev)
    report = {}
    for label, factory in families.items():
        fast, exact = factory(dev, True), factory(dev, False)
        if exact.derivative_apply is not None or exact.microbatch != 2:
            fail(f"exact {label}: fast_derivatives=False is not the micro-batch 2 path")
        batch = fast.attach_neighbors(gather_cases(data, torch.arange(EXACT_CASES)).to(dev))
        # the derivatives on a micro-batch's 2 cases: the exact path's
        # second-order graph of all EXACT_CASES at once is what micro-batches
        # keep from the card's memory
        pair = gather_cases(batch, torch.arange(2, device=dev))
        with torch.no_grad():
            ref = model_derivatives(fast, pair, False, seed=SEED)
            got = model_derivatives(exact, pair, False, seed=SEED)
            frozen = frozen_hierarchy(fast, pair, SEED)
        err_v = check_close(f"exact {label} values against its analytic path, dropout on",
                            [("values", got[0], ref[0])])
        err_f = check_close(f"{label} analytic path against autodiff of the frozen hierarchy, "
                            "every internal row, dropout on",
                            [("values", ref[0], frozen[0]), ("J", ref[1], frozen[1]),
                             ("H", ref[2], frozen[2])], rtol={"H": UNET_H_RTOL})
        coupling = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got[1:], ref[1:])]
        log(f"  exact {label}: its J and H differ from the analytic path's by up to "
            f"{coupling[0]:.3e} and {coupling[1]:.3e} of their largest (the coarse features' "
            "dependence on each point, which the decoupled path drops; not gated)")
        del ref, got, frozen

        # the timed steps start from the same weights, after one warm-up step
        # (the first exact step of the process is the allocator's and
        # cuBLAS's cold start); each setting's peak memory is read over its
        # own step
        variants = ("as built", f"running max over {UNET_K_CHUNKS} chunks",
                    "micro-batches of 1")
        steps = {}
        for variant in ("warm-up",) + variants:
            mdl = factory(dev, False)
            if variant == variants[1]:
                for sa in mdl.module.encoder.children():
                    if isinstance(sa, SetAbstraction):
                        sa.forward = running_max_forward(sa, UNET_K_CHUNKS)
            elif variant == variants[2]:
                mdl = dataclasses.replace(mdl, microbatch=1)
            f1 = make_train_functions(mdl, make_optimizer(mdl, 1), scaler)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, m1 = f1.train_step(f1.init_state(seed=SEED), batch)
            torch.cuda.synchronize()
            steps[variant] = {"ms": (time.perf_counter() - t0) * 1e3,
                              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "metrics": m1, "grads": [p.grad.detach().clone()
                                                       for p in mdl.module.parameters()]}
            del mdl, f1
            torch.cuda.empty_cache()
        names = [n for n, _ in exact.module.named_parameters()]
        built, chunked = steps[variants[0]], steps[variants[1]]
        err_c = check_close(f"exact {label} one step, the running max against one max",
                            [("metrics", chunked["metrics"], built["metrics"])]
                            + [(f"grad {n}", a, r) for n, a, r in
                               zip(names, chunked["grads"], built["grads"])],
                            quiet=True)
        log(f"  exact {label}: one step over {EXACT_CASES} cases: "
            + "; ".join(f"{v} {steps[v]['ms']:.1f} ms, peak {steps[v]['peak_gb']:.3f} GB"
                        for v in variants)
            + f" (torch.cuda.max_memory_allocated; {name}; {smi})")

        def loss_now():
            # a micro-batch at a time: the loss vector is a mean over cases
            total = 0.0
            for i in range(0, EXACT_CASES, 2):
                with torch.no_grad():
                    losses, _ = compute_losses(
                        exact, gather_cases(batch, torch.arange(i, i + 2, device=dev)),
                        deterministic=True)
                total += float((weights * losses).sum()) * 2 / EXACT_CASES
            return total

        before = loss_now()
        fns = make_train_functions(exact, make_optimizer(exact, 1), scaler)
        state = fns.init_state(seed=SEED)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals = []
        for _ in range(UNET_EXACT_STEPS):
            state, m = fns.train_step(state, batch)
            totals.append(m[0])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / UNET_EXACT_STEPS
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        totals = [float(t) for t in totals]
        after = loss_now()
        log(f"exact {label}: {UNET_EXACT_STEPS} steps over {EXACT_CASES} cases, total loss "
            f"with dropout {totals[0]:.6f} -> {totals[-1]:.6f}, without {before:.6f} -> "
            f"{after:.6f}; {ms_step:.1f} ms a step (the host's clock); launches {launches} "
            f"({name}; {smi})")
        if launches:
            fail(f"exact {label}: the exact path launched {launches}")
        if not all(t == t and abs(t) < float("inf") for t in totals) or not after < before:
            fail(f"exact {label}: the loss is not finite or did not fall")
        report[label] = {"values_max_abs_err_against_analytic": err_v,
                         "analytic_against_frozen_hierarchy_max_abs_err": err_f,
                         "exact_against_analytic_j_h_relative": coupling,
                         "running_max_against_one_max_max_abs_err": err_c,
                         "step_ms": {v: steps[v]["ms"] for v in variants},
                         "peak_gb": {v: steps[v]["peak_gb"] for v in variants},
                         "loss_with_dropout": totals,
                         "loss_without_dropout_before_after": [before, after],
                         "ms_per_step": ms_step}
        del fast, exact, fns, state, batch, steps
        torch.cuda.empty_cache()
    return report


def finite_numbers(obj) -> bool:
    """Every number in a JSON-like ``obj`` is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return obj == obj and abs(obj) != float("inf")
    return True


def solver_phase(root, name, smi):
    """Phase 29, the batched 3D solver on the card: the JAX test's two cases
    at its grid against the port's numpy solver, at the JAX test's
    agreement (tests/test_fvm3d_tpu.py:25-40); then abc's D3_TRAIN zoo
    cases and the golden run's 3 held-out ones marched at D3_GRID (the 3D
    golden run's tolerance and step limit) and written under ``root`` as
    the golden run writes them, with each march's ms a step and the steps
    the cases took to converge. Returns the report."""
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.datagen import fvm3d
    from porous_cfd_tpu_torch.datagen.fvm3d_batch import solve_duct3_batch
    from porous_cfd_tpu_torch.tools import train_golden_3d
    dev = torch.device("cuda", 0)
    nx, ny, nz = SOLVER_GRID
    march = {}
    sols = solve_duct3_batch(SOLVER_CASES, nx=nx, ny=ny, nz=nz, tol=SOLVER_TOL,
                             max_steps=SOLVER_STEPS, device=dev, stats=march)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))

    check = {}
    for (shape, center, size, u_in), sol in zip(SOLVER_CASES, sols):
        ref = fvm3d.solve_duct3(shape, center, size, u_inlet=u_in, tol=SOLVER_TOL,
                                max_steps=SOLVER_STEPS, nx=nx, ny=ny, nz=nz)
        uscale = float(np.linalg.norm(np.stack([ref.u, ref.v, ref.w])))
        errs = {"u": rel(sol.u, ref.u),
                "v": float(np.linalg.norm(sol.v - ref.v)) / uscale,
                "w": float(np.linalg.norm(sol.w - ref.w)) / uscale, "p": rel(sol.p, ref.p)}
        m_s = float(np.abs(sol.moment_err[1:-1, 1:-1, 1:-1]).mean())
        m_r = float(np.abs(ref.moment_err[1:-1, 1:-1, 1:-1]).mean())
        check[shape] = {"steps": sol.steps, "numpy_steps": ref.steps,
                        "residual": sol.residual, "rel_err": errs,
                        "momentum_residual_mean": [m_s, m_r]}
        log(f"solver: {shape} at {nx}x{ny}x{nz} on the card in {sol.steps} steps (numpy "
            f"{ref.steps}), residual {sol.residual:.3e}; against numpy u {errs['u']:.3e}, v "
            f"{errs['v']:.3e}, w {errs['w']:.3e}, p {errs['p']:.3e} (at most 2e-3); momentum "
            f"residual {m_s:.3e} against {m_r:.3e}")
        if not (sol.residual < SOLVER_TOL and max(errs.values()) < 2e-3
                and np.array_equal(sol.zone, ref.zone) and m_s < m_r * 1.5 + 1e-8):
            fail(f"solver: the batched march misses the numpy solver on {shape}: {check[shape]}")
    t0 = time.perf_counter()
    train_cases, _ = train_golden_3d.zoo_cases(D3_TRAIN, 0)
    solve = train_golden_3d.generate(root, *D3_GRID, train_cases, train_golden_3d.VAL_CASES,
                                     device=dev)
    write_s = time.perf_counter() - t0 - sum(v["solve_s"] for v in solve.values())
    for split, v in solve.items():
        v["ms_per_step"] = v["solve_s"] * 1e3 / v["steps_marched"]
        log(f"solver: abc {split}, {v['cases']} cases at {'x'.join(map(str, D3_GRID))} "
            f"marched together in {v['solve_s']:.3f} s, {v['steps_marched']} steps at "
            f"{v['ms_per_step']:.4f} ms a step; the cases converged in at most "
            f"{v['max_case_steps']} steps, residual <= {v['max_residual']:.3e} ({name}; {smi})")
        if v["max_residual"] > 2e-3:
            fail(f"solver: an abc {split} case did not converge ({v})")
    log(f"solver: the cases written with their meta in {write_s:.1f} s")
    return {"check": {"grid": list(SOLVER_GRID), "ms_per_step": march["seconds"] * 1e3
                      / march["steps"], "cases": check},
            "abc": {"grid": list(D3_GRID), "write_s": write_s, **solve}}


def write_windbreaks_split(root):
    """windbreaks' synthetic 3D split: D3_TRAIN training and WB_VAL held-out
    cases of WB_CASE_POINTS internal points and five patches (the house's
    ``solid`` among them) of WB_PATCH_POINTS, the example's data config."""
    import numpy as np
    from porous_cfd_tpu_torch.datagen import meta, synthetic_case
    cfg = json.loads((ROOT / "examples" / "windbreaks" / "assets"
                      / "data_config.json").read_text())
    rng = np.random.default_rng(SEED)
    for split, n in (("train", D3_TRAIN), ("val", WB_VAL)):
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=WB_CASE_POINTS,
                                        n_per_patch=WB_PATCH_POINTS, dims=3, d=30000.0,
                                        f=79.731, variable=True, patch_names=WB_PATCHES)
        synthetic_case.write_data_config(root / split, cfg["Fields"],
                                         cfg["Variable boundaries"], cfg["Normalize fields"],
                                         cfg["Dims"])
        meta.generate_meta(root / split, *cfg["Fields"], max_dim=3)
    meta.generate_min_points(root)


def check_3d_kernels(models, data, gen, pk):
    """Phase 3o: every kernel at the 3D experiments' shapes against its plain
    version, both ways, dropout on and off: the engine at D = 3 (abc's two
    decoders, windbreaks' trunk, and the 2D paths' 512 decoder and 352 trunk
    at D = 3, each beside its D = 2 row of 3c-3e); sa_neighborhood on real
    3D chains of ``data`` ({"abc": the solver's cases, "windbreaks": the
    synthetic split}, at the envelope's points): abc's pipn-pp levels and
    U-Net levels at 16 neighbours, windbreaks' at 64; pointnet_global at
    every 3D global level, geometry encoder and branch; FPS over 3D boundary
    clouds (design A) and all points (design B). ``models`` maps each zoo
    name to its model on the card. Returns {kernel key: {shape: numbers}}."""
    import torch
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors, fps_count
    from porous_cfd_tpu_torch.train.engine import gather_cases
    dev = torch.device("cuda", 0)
    out = {k: {} for k in ("decoder_prop", "decoder_prop_bwd", "neural_ops_prop",
                           "neural_ops_prop_bwd", "sa_neighborhood", "sa_neighborhood_bwd",
                           "pointnet_global", "pointnet_global_bwd",
                           "farthest_point_sampling")}

    def put(key, label, res, **shape):
        out[key][label] = {**shape, **shape_timing(res, pk), **res.get("extra", {})}

    # the engine at D = 3, each backward split into its rows sweep and its
    # weight gradients (beside cuBLAS) at the D = 3 stash rows
    for label, seg, drop in (("abc pipn", [1024 + 64, 512, 256, 128, 4], [0.03, 0.02, 0, 0]),
                             ("abc pipn-pp", [1024 + 64, 384, 128, 4], [0.03, 0, 0]),
                             ("pipn's widths at D = 3", SEG, SEG_DROPOUT)):
        pair = check_decoder(seg, drop, gen, f"{label} D=3", dims=3)
        split_backward(torch, pair[1], grad_shapes(*[[FE_LOCAL[-1]] + seg[1:]] * 2, dims=3), pk)
        for i, key in enumerate(("decoder_prop", "decoder_prop_bwd")):
            put(key, label, pair[i], widths=seg, dropout=drop, dims=3)
        torch.cuda.empty_cache()
    for label, kw in (("windbreaks", dict(n_local=256, f=512, n_ops=4,
                                          rates=[0, 0.15, 0.15, 0], n_red=4)),
                      ("pi-gano's widths at D = 3", {})):
        pair = check_trunk(gen, dims=3, tag=f"{label} D=3", **kw)
        widths = ([kw.get("n_local", PG_LOCAL[-1])] + [kw.get("f", PG_BRANCH[-1])]
                  * kw.get("n_ops", PG_OPERATORS) + [kw.get("n_red", 3)])
        split_backward(torch, pair[1], grad_shapes(widths, widths, dims=3), pk)
        for i, key in enumerate(("neural_ops_prop", "neural_ops_prop_bwd")):
            put(key, label, pair[i], dims=3, **{k: v for k, v in kw.items() if k != "rates"})
        torch.cuda.empty_cache()

    # the ++ models' radius levels, on each experiment's real chain
    for label, model_name, seq_of in (
            ("abc pipn-pp", "abc pipn-pp", lambda m: m.module.feature_extract.global_feature),
            ("windbreaks pi-gano-pp", "windbreaks pi-gano-pp",
             lambda m: m.module.geometry_encoder.set_abstraction)):
        model = models[model_name]
        chain = model.neighbor_precompute(
            gather_cases(data[label.split()[0]], torch.arange(BATCH)).to(dev))
        res = check_sa(seq_of(model), chain, gen, pk, 2)
        for i, key in enumerate(("sa_neighborhood", "sa_neighborhood_bwd")):
            put(key, label, res[i], neighbors=model.module.max_neighbors
                if hasattr(model.module, "max_neighbors") else None)
        del chain

    # FPS over the 3D boundary clouds (PIPN++'s levels) and all points (the
    # U-Nets'), every case
    for exp in ("abc", "windbreaks"):
        internal, boundary = split_contiguous(data[exp])
        bnd = boundary["C"].contiguous().to(dev)
        lv = [fps_count(bnd.shape[1], 0.5)]
        lv.append(fps_count(lv[0], 0.25))
        fps = fps_levels(torch, bnd, lv, f"{exp} boundary clouds")
        b_fps = bound(fps["flops"], fps["nbytes"], *pk)
        out["farthest_point_sampling"][f"{exp} boundary"] = {
            "input": list(bnd.shape), "samples": lv, "ms": fps["ms"],
            "device_ms": fps["device_ms"], "plain_ms": fps["plain_ms"], "bound_ms": b_fps[0],
            "bound_by": b_fps[1], "bound_f32_core_ms": b_fps[2], "flop": fps["flops"],
            "bytes": fps["nbytes"], "max_abs_err": 0.0, "levels": fps["levels"]}
        pts = torch.cat([internal["C"], boundary["C"]], dim=-2).contiguous().to(dev)
        lv_all = [fps_count(pts.shape[1], 0.5)]
        lv_all.append(fps_count(lv_all[0], 0.25))
        fps = fps_levels(torch, pts, lv_all, f"{exp} all points")
        if fps["levels"]["level_0"]["design"]["kind"] != "B":
            fail(f"FPS over {pts.shape[1]} 3D points did not take design B")
        b_fps = bound(fps["flops"], fps["nbytes"], *pk)
        out["farthest_point_sampling"][f"{exp} all points"] = {
            "input": list(pts.shape), "samples": lv_all, "ms": fps["ms"],
            "device_ms": fps["device_ms"], "plain_ms": fps["plain_ms"], "bound_ms": b_fps[0],
            "bound_by": b_fps[1], "bound_f32_core_ms": b_fps[2], "flop": fps["flops"],
            "bytes": fps["nbytes"], "max_abs_err": 0.0, "levels": fps["levels"]}

    # the U-Nets' levels over all points, and their global levels
    for label in ("abc pipn-pp-full", "windbreaks pi-gano-pp-full"):
        model = models[label]
        exp_data = data[label.split()[0]]
        chain = model.neighbor_precompute(gather_cases(exp_data, torch.arange(BATCH)).to(dev))
        nbrs = extract_sa_neighbors(chain, 2)
        enc = model.module.encoder
        internal, boundary = split_contiguous(exp_data)
        n_pts = internal["C"].shape[1] + boundary["C"].shape[1]
        n_src = [n_pts, fps_count(n_pts, enc.fraction[0])]
        for i in range(2):
            res = check_sa_level(f"{label} level {i} dynamic", getattr(enc, f"sa_{i}").conv_mlp,
                                 nbrs[i], None, n_src[i], gen, pk)
            out["sa_neighborhood"][f"{label} level {i}"] = res["fwd"]
            out["sa_neighborhood_bwd"][f"{label} level {i}"] = res["bwd"]
        del chain

    # pointnet_global at every 3D global level, encoder and branch: (label,
    # widths, rows a case, with dx)
    n_pts = N_INT + N_BND
    wb = models["windbreaks pi-gano"].module
    n_branch = int(data["windbreaks"]["inlet"]["C"].shape[-2]) + N_INT
    for label, widths, rows, dx in (
            ("abc pipn", list(models["abc pipn"].module.feature_extract.global_feature.layers), n_pts, True),
            ("abc pipn-pp global",
             list(models["abc pipn-pp"].module.feature_extract.global_feature.global_sa
                  .mlp.layers), 125, True),
            ("abc pipn-pp-full global",
             list(models["abc pipn-pp-full"].module.encoder.global_sa.mlp.layers), 313, True),
            ("windbreaks geometry", list(wb.geometry_encoder.linear.layers), n_pts, False),
            ("windbreaks branch", list(wb.branch.linear.layers), n_branch, False),
            ("windbreaks pi-gano-pp global",
             list(models["windbreaks pi-gano-pp"].module.geometry_encoder.set_abstraction
                  .global_sa.mlp.layers), 125, True),
            ("windbreaks pi-gano-pp-full global",
             list(models["windbreaks pi-gano-pp-full"].module.encoder.global_sa.mlp.layers),
             313, True),
            ("windbreaks pi-gano-pp-full branch",
             list(models["windbreaks pi-gano-pp-full"].module.branch.linear.layers), n_branch,
             False)):
        pair = check_pointnet(widths, rows, dx, gen, label)
        for i, key in enumerate(("pointnet_global", "pointnet_global_bwd")):
            put(key, label, pair[i], input=[BATCH, rows, widths[0]], widths=widths)
    return out


def cli_3d_phase(experiment, model_names, root, weights_of, counters, name, smi):
    """Phase 36, a 3D experiment's CLIs on the card (``experiment`` "abc" or
    "windbreaks", over the split under ``root``): for each of
    ``model_names`` the training CLI trains D3_CLI_EPOCHS epochs at the
    envelope's points and batch BATCH, bf16-mixed validation (the first
    model of D3_CLI_SUBPROCESS through ``python -m`` in a subprocess, the
    others in process with their launch counts), writing model.ckpt, best.ckpt and model_meta.json;
    the training loss without dropout falls (the CLI's initial weights
    against the trained ones on the training split as the CLI sampled it);
    the inference CLI restores the checkpoint and predicts each held-out
    case as the trained weights do on the whole split, within RTOL; the
    evaluate CLI's line holds finite numbers. Returns {model: report}."""
    import contextlib
    import importlib
    import io
    import re
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_predict_functions)
    pkg = f"porous_cfd_tpu_torch.examples.{experiment}"
    train, inference, evaluate = (importlib.import_module(f"{pkg}.{m}")
                                  for m in ("train", "inference", "evaluate"))
    dev = torch.device("cuda", 0)
    points = ["--n-internal", str(N_INT), "--n-boundary", str(N_BND),
              "--n-observations", str(N_OBS)]
    held_out = ["--data-dir", str(root / "val"), "--meta-dir", str(root / "train")]
    kernels_of = {"pipn": {"pointnet_global", "decoder_prop"},
                  "pipn-pp": {"sa_neighborhood", "pointnet_global", "decoder_prop",
                              "farthest_point_sampling"},
                  "pipn-pp-full": {"sa_neighborhood", "pointnet_global",
                                   "farthest_point_sampling"},
                  "pi-gano": {"pointnet_global", "neural_ops_prop"},
                  "pi-gano-pp": {"sa_neighborhood", "pointnet_global", "neural_ops_prop",
                                 "farthest_point_sampling"},
                  "pi-gano-pp-full": {"sa_neighborhood", "pointnet_global",
                                      "farthest_point_sampling"}}
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        for j, model_type in enumerate(model_names):
            argv = ["--model", model_type, "--epochs", str(D3_CLI_EPOCHS), "--log-every", "10",
                    "--batch-size", str(BATCH), *points, "--train-dir", str(root / "train"),
                    "--val-dir", str(root / "val"), "--logs-dir", str(Path(tmp) / "logs"),
                    "--name", model_type]
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            sub = j == 0 and experiment == D3_CLI_SUBPROCESS
            if sub:
                cmd = [sys.executable, "-m", f"{pkg}.train", *argv]
                log(f"{experiment} cli: running " + " ".join(cmd[1:]))
                proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                      timeout=900)
                printed, launches = proc.stdout, None
                if proc.returncode != 0:
                    fail(f"{experiment} cli ({model_type}) exited {proc.returncode}: "
                         f"{proc.stderr[-3000:]}")
                model = None
            else:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    model = train.run(argv)
                printed = buf.getvalue()
                launches = {k: c.launches for k, c in counters.items() if c.launches}
                if not kernels_of[model_type] <= set(launches) or not any(
                        k.endswith("_bwd") for k in launches):
                    fail(f"{experiment} cli {model_type}: launches {launches} lack a kernel "
                         f"of {kernels_of[model_type]}")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            for line in printed.splitlines():
                log(f"  | {line}")
            log_dir = Path(tmp) / "logs" / "lightning_logs" / model_type
            for fname in ("model.ckpt", "best.ckpt", "model_meta.json"):
                if not (log_dir / fname).exists():
                    fail(f"{experiment} cli {model_type}: the CLI did not write {fname}")
            model_meta = json.loads((log_dir / "model_meta.json").read_text())
            if model_meta["Model type"] != model_type or model_meta["N boundary"] != N_BND:
                fail(f"{experiment} cli {model_type}: model_meta.json {model_meta}")
            found = re.search(r"fit: \d+ epochs in ([0-9.]+) s, ([0-9.]+) ms per epoch; the "
                              r"first (\d+) in ([0-9.]+) s, then ([0-9.]+) ms per epoch",
                              printed)
            if found is None:
                fail(f"{experiment} cli {model_type}: the CLI did not report its fit time")
            ms_epoch, ms_steady = float(found.group(2)), float(found.group(5))
            ckpt = torch.load(log_dir / "model.ckpt", map_location=dev, weights_only=True)

            # the training loss without dropout, the CLI's initial weights
            # against the trained ones
            args = train.build_arg_parser().parse_args(argv)
            train_data = FoamDataset(str(root / "train"), N_INT, N_BND, N_OBS,
                                     rng=np.random.default_rng(train.SEED))
            scaler_w = torch.tensor(weights_of, device=dev)
            initial = train.get_model(args, train_data.normalizers, dev)
            trained = train.get_model(args, train_data.normalizers, dev)
            trained.module.load_state_dict(ckpt["module"])
            totals = []
            for mdl in (initial, trained):
                batch = mdl.attach_neighbors(train_data.stacked().to(dev))
                with torch.no_grad():
                    losses, _ = compute_losses(mdl, batch, deterministic=True)
                totals.append(float((scaler_w * losses).sum()))
            fall = (totals[0] - totals[1]) / totals[0]
            if not fall > 0:
                fail(f"{experiment} cli {model_type}: the training loss did not fall "
                     f"({totals})")
            if model is not None:
                for a, b in zip(model.module.parameters(), trained.module.parameters()):
                    if not torch.equal(a, b):
                        fail(f"{experiment} cli {model_type}: model.ckpt is not the trained "
                             "module")

            # inference: the checkpoint restored, each held-out case alone
            # in f32, against the trained weights on the whole split
            inf_argv = ["--checkpoint", str(log_dir / "model.ckpt"), *held_out, *points]
            preds = inference.run(inf_argv + ["--precision", "32-true"])
            val_data = FoamDataset(str(root / "val"), N_INT, N_BND, N_OBS,
                                   np.random.default_rng(train.SEED), str(root / "train"))
            stacked = trained.attach_neighbors(val_data.stacked().to(dev))
            ref = make_predict_functions(trained).predict_batch(
                gather_cases(stacked, torch.arange(len(val_data), device=dev))).data.cpu()
            err_inf = check_close(f"{experiment} cli {model_type} inference against the "
                                  "trained weights",
                                  [(f"case {i}", torch.as_tensor(p_.data), ref[i])
                                   for i, p_ in enumerate(preds)])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                summary = evaluate.run(inf_argv)
            log(f"  | {buf.getvalue().strip()}")
            if not finite_numbers(summary):
                fail(f"{experiment} cli {model_type}: evaluate printed a non-finite number "
                     f"{summary}")
            log(f"{experiment} cli {model_type}: {D3_CLI_EPOCHS} epochs of {D3_TRAIN} cases "
                f"at {N_INT}/{N_BND}/{N_OBS} points in {wall_s:.1f} s for the whole command"
                f"{' (a subprocess)' if sub else ''}, {ms_epoch:.3f} ms per epoch (the "
                f"trainer's clock, bf16-mixed validation every 10 epochs included), "
                f"{ms_steady:.3f} after the first chunk; training loss without dropout "
                f"{totals[0]:.6f} -> {totals[1]:.6f}, a fall of {fall:.3e} of it; inference "
                f"within {err_inf:.3e} of the trained weights; evaluate {json.dumps(summary)} "
                f"({name}; {smi})")
            reports[model_type] = {"command_s": wall_s, "subprocess": sub,
                                   "ms_per_epoch": ms_epoch,
                                   "ms_per_epoch_after_first": ms_steady,
                                   "launches": launches, "loss_initial_trained": totals,
                                   "loss_fall": fall, "inference_max_abs_err": err_inf,
                                   "evaluate": summary, "model_meta": model_meta}
            del model, initial, trained
            torch.cuda.empty_cache()
    return reports


def solver_2d_phase(name, smi):
    """Phase 37, the batched 2D solver on the card (``datagen/fvm_batch.py``):
    the JAX test's three cases at its grid against the port's numpy solver,
    at the JAX test's agreement (tests/test_fvm_tpu.py:29-50: U, v and p
    within 2e-3, the zones equal, the momentum residual at most 1.5 times
    the numpy solver's); then one chunk of GRID_CHUNK cases of the
    621-case transform grid at GRID_2D, the grid tool's tolerance and step
    limit: its wall, ms a step and the cases' largest and median step
    counts. Returns the report."""
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.datagen import fvm
    from porous_cfd_tpu_torch.datagen.fvm_batch import solve_duct_batch
    from porous_cfd_tpu_torch.tools import golden_transform_grid as grid
    dev = torch.device("cuda", 0)
    nx, ny = SOLVER2_GRID
    march, eager_march = {}, {}
    sols = solve_duct_batch(SOLVER2_CASES, nx=nx, ny=ny, tol=SOLVER2_TOL,
                            max_steps=SOLVER2_STEPS, device=dev, stats=march)
    eager = solve_duct_batch(SOLVER2_CASES, nx=nx, ny=ny, tol=SOLVER2_TOL,
                             max_steps=SOLVER2_STEPS, device=dev, stats=eager_march,
                             graph=False)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))

    # the captured step (a CUDA graph) against the same step launched eagerly
    graph_err = max(max(rel(g.u, e.u), rel(g.v, e.v) if np.linalg.norm(e.v) > 1e-9 else 0.0,
                        rel(g.p, e.p)) for g, e in zip(sols, eager))
    step_gap = max(abs(g.steps - e.steps) for g, e in zip(sols, eager))
    ms_graph = march["seconds"] * 1e3 / march["steps"]
    ms_eager = eager_march["seconds"] * 1e3 / eager_march["steps"]
    log(f"solver 2D: the graph-replayed march against eager launches: fields within "
        f"{graph_err:.3e}, steps within {step_gap}; ms a step {ms_graph:.4f} replayed, "
        f"{ms_eager:.4f} eager ({len(SOLVER2_CASES)} cases at {nx}x{ny}, the capture "
        f"included)")
    if graph_err > 1e-5 or step_gap > 1:
        fail(f"solver 2D: the graph-replayed march differs from the eager one ({graph_err}, "
             f"{step_gap} steps)")

    check = {}
    for case, sol in zip(SOLVER2_CASES, sols):
        ref = fvm.solve_duct(**case, tol=SOLVER2_TOL, max_steps=SOLVER2_STEPS, nx=nx, ny=ny)
        uscale = float(np.linalg.norm(np.stack([ref.u, ref.v])))
        errs = {"u": rel(sol.u, ref.u), "v": float(np.linalg.norm(sol.v - ref.v)) / uscale,
                "p": rel(sol.p, ref.p)}
        m_s = float(np.abs(sol.moment_err[1:-1, 1:-1]).mean())
        m_r = float(np.abs(ref.moment_err[1:-1, 1:-1]).mean())
        check[case["shape"]] = {"steps": sol.steps, "numpy_steps": ref.steps,
                                "residual": sol.residual, "rel_err": errs,
                                "momentum_residual_mean": [m_s, m_r]}
        log(f"solver 2D: {case['shape']} at {nx}x{ny} on the card in {sol.steps} steps (numpy "
            f"{ref.steps}), residual {sol.residual:.3e}; against numpy u {errs['u']:.3e}, v "
            f"{errs['v']:.3e}, p {errs['p']:.3e} (at most 2e-3); momentum residual {m_s:.3e} "
            f"against {m_r:.3e}")
        if not (sol.residual < SOLVER2_TOL and max(errs.values()) < 2e-3
                and np.array_equal(sol.zone, ref.zone) and m_s < m_r * 1.5 + 1e-8):
            fail(f"solver 2D: the batched march misses the numpy solver on {case['shape']}: "
                 f"{check[case['shape']]}")

    splits = grid.split_cases(grid.enumerate_meshes(3, 2), np.random.default_rng(grid.SEED))
    cases = splits["train"][:GRID_CHUNK]
    chunk = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = solve_duct_batch([grid._solve_params(c) for c in cases], nx=GRID_2D[0],
                            ny=GRID_2D[1], tol=grid.TOL["batch"], max_steps=GRID_MAX_STEPS,
                            device=dev, stats=chunk)
    wall = time.perf_counter() - t0
    steps = [s.steps for s in sols]
    residuals = [s.residual for s in sols]
    if not all(np.isfinite(s.u).all() and np.isfinite(s.p).all() for s in sols):
        fail("solver 2D: a grid case came back with non-finite fields")
    summary = {"cases": len(cases), "grid": list(GRID_2D), "tol": grid.TOL["batch"],
               "wall_s": wall, "march_s": chunk["seconds"], "steps_marched": chunk["steps"],
               "ms_per_step": chunk["seconds"] * 1e3 / chunk["steps"],
               "max_case_steps": max(steps), "median_case_steps": float(np.median(steps)),
               "unconverged": sum(r >= grid.TOL["batch"] for r in residuals),
               "max_residual": max(residuals)}
    log(f"solver 2D: {len(cases)} grid cases at {GRID_2D[0]}x{GRID_2D[1]}, tol "
        f"{grid.TOL['batch']}: {wall:.2f} s with set-up and post-processing, the march "
        f"{chunk['seconds']:.2f} s for {chunk['steps']} steps, {summary['ms_per_step']:.4f} ms "
        f"a step; case steps at most {max(steps)}, median {summary['median_case_steps']:.0f}; "
        f"{summary['unconverged']} unconverged, residual <= {max(residuals):.3e} "
        f"({name}; {smi})")
    # the same chunk launched eagerly, GRID_EAGER_STEPS steps: the host's
    # pace without the graph
    eager_chunk = {}
    solve_duct_batch([grid._solve_params(c) for c in cases], nx=GRID_2D[0], ny=GRID_2D[1],
                     tol=grid.TOL["batch"], max_steps=GRID_EAGER_STEPS, device=dev,
                     stats=eager_chunk, graph=False)
    summary["eager_ms_per_step"] = eager_chunk["seconds"] * 1e3 / eager_chunk["steps"]
    log(f"solver 2D: the chunk launched eagerly for {eager_chunk['steps']} steps: "
        f"{summary['eager_ms_per_step']:.4f} ms a step against {summary['ms_per_step']:.4f} "
        f"replayed")
    return {"check": {"grid": list(SOLVER2_GRID), "ms_per_step": ms_graph,
                      "eager_ms_per_step": ms_eager, "graph_vs_eager_rel": graph_err,
                      "graph_vs_eager_steps": step_gap, "cases": check},
            "grid_chunk": summary}


def hard_vertical_cli_phase(keep, name, smi, counters):
    """Phase 38, the duct_fixed_boundary_hard and vertical_duct_fixed_boundary
    CLIs on the card, on phase 18's golden-duct cases and ``pipn``
    checkpoint (under ``keep``). The hard CLI trains ``pipn`` FIX_EPOCHS
    epochs with its loss weights (observations [30, 30, 100]): its launch
    counts, its training loss without dropout falling by FIX_MIN_FALL of
    itself; its inference CLI restores the checkpoint and predicts each
    held-out case as the trained weights do within RTOL; its evaluate CLI
    prints finite numbers. The vertical CLI fine-tunes phase 18's
    checkpoint for VERT_EPOCHS more epochs on a written two-inlet
    (``inlet-top``) split: it resumes at the checkpoint's epoch, its
    training loss without dropout falls from the checkpoint's, its
    inference restores and its evaluate prints finite numbers."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.datagen import meta, synthetic_case
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard import (
        evaluate as hard_evaluate, inference as hard_inference, train as hard_train)
    from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary import (
        evaluate as v_evaluate, inference as v_inference, train as v_train)
    from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset \
        import VerticalDuctDataset
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases,
                                                   make_predict_functions)
    from porous_cfd_tpu_torch.train.trainer import load_checkpoint
    dev = torch.device("cuda", 0)
    keep = Path(keep)
    fixed_ckpt = keep / "logs" / "lightning_logs" / "pipn" / "model.ckpt"
    n_int, n_bnd, n_obs = FIX_POINTS
    points = ["--n-internal", str(n_int), "--n-boundary", str(n_bnd),
              "--n-observations", str(n_obs)]
    report = {}

    def training_loss(model, root, dataset_cls, weights):
        data = dataset_cls(str(root / "train"), n_int, n_bnd, n_obs,
                           rng=np.random.default_rng(fixed_train.SEED))
        batch = model.attach_neighbors(data.stacked().to(dev))
        with torch.no_grad():
            losses, _ = compute_losses(model, batch, deterministic=True)
        return float((torch.tensor(weights, device=dev) * losses).sum())

    def run_cli(label, train_mod, inference_mod, evaluate_mod, dataset_cls, root, argv,
                initial):
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            model = train_mod.run(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        if not {"pointnet_global", "decoder_prop", "pointnet_global_bwd",
                "decoder_prop_bwd"} <= set(launches):
            fail(f"{label} cli: launches {launches} lack a kernel of pipn's path")
        args = train_mod.build_arg_parser().parse_args(argv)
        weights = train_mod.get_loss_scaler(args).weights
        totals = [training_loss(initial(args), root, dataset_cls, weights),
                  training_loss(model, root, dataset_cls, weights)]
        fall = (totals[0] - totals[1]) / totals[0]
        inf_argv = ["--checkpoint", str(Path(args.logs_dir) / "lightning_logs" / args.name
                                        / "model.ckpt"),
                    "--data-dir", str(root / "val"), "--meta-dir", str(root / "train"), *points]
        preds = inference_mod.run(inf_argv + ["--precision", "32-true"])
        val = dataset_cls(str(root / "val"), n_int, n_bnd, n_obs,
                          np.random.default_rng(fixed_train.SEED), str(root / "train"))
        stacked = model.attach_neighbors(val.stacked().to(dev))
        with torch.no_grad():
            ref = make_predict_functions(model).predict_batch(
                gather_cases(stacked, torch.arange(len(val), device=dev))).data.cpu()
        err_inf = check_close(f"{label} cli inference against the trained model",
                              [(f"case {i}", torch.as_tensor(p_.data), ref[i])
                               for i, p_ in enumerate(preds)])
        printed_eval = io.StringIO()
        with contextlib.redirect_stdout(printed_eval):
            summary = evaluate_mod.run(inf_argv)
        log(f"  | {printed_eval.getvalue().strip()}")
        if not finite_numbers(summary) or summary["cases"] != len(val):
            fail(f"{label} cli: evaluate printed {summary}")
        log(f"{label} cli: {wall_s:.1f} s for the training command; launches {launches}; "
            f"training loss without dropout {totals[0]:.6f} -> {totals[1]:.6f}, a fall of "
            f"{fall:.3e} of it; inference within {err_inf:.3e} of the trained model; evaluate "
            f"{json.dumps(summary)} ({name}; {smi})")
        del model
        torch.cuda.empty_cache()
        return {"command_s": wall_s, "launches": launches, "loss_initial_trained": totals,
                "loss_fall": fall, "inference_max_abs_err": err_inf, "evaluate": summary,
                "printed": printed.getvalue()}

    # the hard CLI on phase 18's golden cases, from the seeded weights
    root = keep / "data"
    train_data = FoamDataset(str(root / "train"), n_int, n_bnd, n_obs,
                             rng=np.random.default_rng(fixed_train.SEED))
    argv = ["--model", "pipn", "--epochs", str(FIX_EPOCHS), "--log-every", "10",
            "--batch-size", str(FIX_TRAIN), *points, "--train-dir", str(root / "train"),
            "--val-dir", str(root / "val"), "--logs-dir", str(keep / "hard_logs"),
            "--name", "pipn-hard"]
    report["hard"] = run_cli("hard", hard_train, hard_inference, hard_evaluate, FoamDataset,
                             root, argv,
                             lambda a: fixed_train.get_model(a, train_data.normalizers, dev))
    if not report["hard"]["loss_fall"] >= FIX_MIN_FALL:
        fail(f"hard cli: the training loss fell by {report['hard']['loss_fall']:.3e} of itself")

    # the vertical CLI: a written two-inlet split, fine-tuned from phase 18's
    # pipn checkpoint
    v_root = keep / "vertical"
    rng = np.random.default_rng(SEED)
    for split, n in (("train", FIX_TRAIN), ("val", FIX_VAL)):
        synthetic_case.write_foam_split(v_root / split, n, rng, n_internal=VERT_POINTS,
                                        n_per_patch=VERT_PATCH_POINTS,
                                        patch_names=VERT_PATCHES)
        synthetic_case.write_data_config(v_root / split, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(v_root / split, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(v_root)
    v_train_data = VerticalDuctDataset(str(v_root / "train"), n_int, n_bnd, n_obs,
                                       rng=np.random.default_rng(fixed_train.SEED))
    start = torch.load(fixed_ckpt, weights_only=True, map_location="cpu")

    def from_checkpoint(a):
        model = fixed_train.get_model(a, v_train_data.normalizers, dev)
        load_checkpoint(str(fixed_ckpt), model)
        return model

    argv = ["--model", "pipn", "--epochs", str(start["epoch"] + VERT_EPOCHS), "--log-every",
            "10", "--batch-size", str(FIX_TRAIN), *points, "--checkpoint", str(fixed_ckpt),
            "--train-dir", str(v_root / "train"), "--val-dir", str(v_root / "val"),
            "--logs-dir", str(keep / "vertical_logs"), "--name", "pipn-vertical"]
    report["vertical"] = run_cli("vertical", v_train, v_inference, v_evaluate,
                                 VerticalDuctDataset, v_root, argv, from_checkpoint)
    if f"resumed from {fixed_ckpt} at epoch {start['epoch']}" not in \
            report["vertical"]["printed"]:
        fail("vertical cli: the run did not resume from phase 18's checkpoint")
    done = torch.load(keep / "vertical_logs" / "lightning_logs" / "pipn-vertical" / "model.ckpt",
                      weights_only=True, map_location="cpu")
    if done["epoch"] != start["epoch"] + VERT_EPOCHS:
        fail(f"vertical cli: its checkpoint is at epoch {done['epoch']}")
    if not report["vertical"]["loss_fall"] > 0:
        fail(f"vertical cli: the fine-tuned loss did not fall from the checkpoint's "
             f"({report['vertical']['loss_initial_trained']})")
    report["vertical"]["resumed_at_epoch"] = start["epoch"]
    for r in report.values():
        r.pop("printed")
    return report


def grid_phase(name, smi, counters):
    """Phase 39, a small transform grid through the grid tools on the card:
    GRID_SMALL cases of the fixed grid's seed-8421 split written by
    ``golden_transform_grid.generate`` with the batched solver at GRID_2D;
    ``train_golden_grid`` trains ``pipn`` on its coupled path (the
    north-star recipe's path) GRID_EPOCHS epochs at batch 13, resampling
    every 10, at the golden points (FIX_POINTS), scores the three splits
    and runs the evaluate CLI;
    ``analyze_grid_errors`` and ``analyze_p_offset`` read its checkpoint.
    Launch counts of the training, every number finite."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.tools import (analyze_grid_errors, analyze_p_offset,
                                            golden_transform_grid as grid, train_golden_grid)
    dev = torch.device("cuda", 0)
    splits = grid.split_cases(grid.enumerate_meshes(2, 1), np.random.default_rng(grid.SEED))
    sub = {k: splits[k][:n] for k, n in zip(("train", "val", "test"), GRID_SMALL)}
    report = {"cases": {k: len(v) for k, v in sub.items()}, "epochs": GRID_EPOCHS}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "grid"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report["solve"] = grid.generate(root, sub, *GRID_2D, 4000, False, solver="batch",
                                            device=dev)
        report["generate_s"] = time.perf_counter() - t0
        metas = [json.loads(p.read_text()) for p in root.rglob("solver.json")]
        if len(metas) != sum(GRID_SMALL) or {m["solver"] for m in metas} != {"batch_f32"}:
            fail(f"grid: the generator wrote {len(metas)} solver.json files")
        log(f"grid: {sum(GRID_SMALL)} cases solved by the batched march and written in "
            f"{report['generate_s']:.1f} s: " + json.dumps(report["solve"]))
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        n_int, n_bnd, n_obs = FIX_POINTS
        points = ["--n-internal", str(n_int), "--n-boundary", str(n_bnd), "--n-obs", str(n_obs)]
        with contextlib.redirect_stdout(printed):
            scores = train_golden_grid.main(["--root", str(root), "--epochs",
                                             str(GRID_EPOCHS), "--paths", "analytic",
                                             "--resample-every", "10", *points])
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        if not {"pointnet_global", "decoder_prop", "decoder_prop_j0_add",
                "decoder_prop_j0_add_bwd"} <= set(launches):
            fail(f"grid: the coupled path's launches {launches} lack a kernel")
        if not finite_numbers(scores) or not (root / "logs" / "grid_scores.json").exists():
            fail(f"grid: train_golden_grid returned {scores}")
        with contextlib.redirect_stdout(io.StringIO()):
            rows = analyze_grid_errors.main(["--root", str(root), *points])
            offsets = analyze_p_offset.main(["--root", str(root), *points])
        if len(rows["rows"]) != sum(GRID_SMALL) or not finite_numbers(rows["summary"]) \
                or not finite_numbers(offsets):
            fail("grid: the analyses returned non-finite numbers or missed cases")
        run = scores["analytic"]
        log(f"grid: train_golden_grid {GRID_EPOCHS} epochs of pipn (coupled) in "
            f"{run['wall_s']:.1f} s, {run['steps_per_s']:.1f} steps/s with the data's load; "
            f"rel-L2 U / p train {run['train']['U']:.4f} / {run['train']['p']:.4f}, val "
            f"{run['val']['U']:.4f} / {run['val']['p']:.4f}, test {run['test']['U']:.4f} / "
            f"{run['test']['p']:.4f}; launches {launches}; p offsets "
            f"{json.dumps(offsets)} ({name}; {smi})")
        report.update(scores=scores, launches=launches, per_case=rows["summary"],
                      p_offset=offsets)
    return report


def p_values(line) -> list:
    """Every p-value of a compare summary line as (family, label, value):
    ``rank`` for the rank tests, ``log`` for those over the errors' logs."""
    return ([("log" if t == "ANOVA" else "rank", f"{t} {f}", v)
             for f, tests in line["test"].items() for t, v in tests.items()]
            + [("log", f"Shapiro {f} {m}", v)
               for f, models in line["shapiro"].items() for m, v in models.items()]
            + [("log", f"Levene {f}", v) for f, v in line["levene"].items()])


def log_tests(errors, keep, fields, names) -> dict:
    """The compare's tests over the errors' logs (ANOVA, Shapiro of each
    model, Levene about the mean), field by field, over the errors that
    ``keep`` keeps of each model's (points, fields) ``errors``: {label:
    p-value}, labelled as ``p_values`` labels them."""
    import numpy as np
    from scipy.stats import f_oneway, levene, shapiro
    out = {}
    for i, f in enumerate(fields):
        t = [np.log(e[k[:, i], i]) for e, k in zip(errors, keep)]
        out[f"ANOVA {f}"] = float(f_oneway(*t)[-1])
        for m, x in zip(names, t):
            out[f"Shapiro {f} {m}"] = float(shapiro(x)[-1])
        out[f"Levene {f}"] = float(levene(*t, center="mean")[-1])
    return out


def p_gap(card: dict, cpu: dict, gate: bool) -> float:
    """The largest gap between two {label: p-value} dicts relative to the
    larger of each pair, where they differ by more than COMPARE_P_ATOL; with
    ``gate``, fails past COMPARE_P_RTOL."""
    worst = 0.0
    for label, a in card.items():
        b = cpu[label]
        if abs(a - b) <= COMPARE_P_ATOL:
            continue
        gap = abs(a - b) / max(abs(a), abs(b), 1e-300)
        if gate and gap > COMPARE_P_RTOL:
            fail(f"compare: {label} p-value {a!r} on the card, {b!r} on the CPU (allowed "
                 f"{COMPARE_P_RTOL:.0e} relative or {COMPARE_P_ATOL:.0e})")
        worst = max(worst, gap)
    return worst


def compare_phase(fixed_keep, variable_keep, counters, name, smi):
    """Phase 40, the evaluation's output layer on the card: the fixed
    duct's compare CLI on phase 18's held-out split and checkpoints,
    ``pipn`` against ``pipn-pp-mrg``, in process with every launch count set
    to 0 just before and read just after (pointnet_global, decoder_prop,
    sa_neighborhood and FPS forward, no backward; its summary line parses,
    ``Test.csv`` and ``Shapiro.csv`` are written, every p-value lies in [0,
    1]; in process, since a subprocess costs about 20 s of start-up on the
    card's machine); the two
    error arrays and the p-values against the same compare with
    ``device="cpu"`` (errors within RTOL of their largest; the rank tests'
    p-values within COMPARE_P_RTOL of the larger of the two, or
    COMPARE_P_ATOL, and so the log-error tests' over the errors above the
    card's noise floor, COMPARE_LOG_FLOOR); the
    variable duct's compare CLI on phase 15's split, ``pi-gano-full``
    against ``pi-gano-pp-full``, in process (neural_ops_prop too); the
    fixed evaluate CLI's error table on the card and on the CPU (finite, the
    same row labels); then ``--save-plots``: without matplotlib the
    evaluate, inference and compare CLIs raise the ImportError that names
    it, with no launch; with it, each writes the JAX package's file names.
    Returns the report."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import compare as fixed_compare
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate, inference
    from porous_cfd_tpu_torch.examples.duct_variable_boundary import compare as var_compare
    t_phase = time.perf_counter()
    fixed, variable = Path(fixed_keep), Path(variable_keep)
    n_int, n_bnd, n_obs = FIX_POINTS
    fixed_logs = fixed / "logs" / "lightning_logs"
    fixed_argv = ["--checkpoint", str(fixed_logs / "pipn" / "model.ckpt"),
                  "--data-dir", str(fixed / "data" / "val"),
                  "--meta-dir", str(fixed / "data" / "train"), "--n-internal", str(n_int),
                  "--n-boundary", str(n_bnd), "--n-observations", str(n_obs)]
    other = ["--checkpoint-other", str(fixed_logs / "pipn-pp-mrg" / "model.ckpt")]
    report = {}

    def quietly(fn, *args, **kwargs):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = fn(*args, **kwargs)
        return out, printed.getvalue()

    def counted(fn, *args, **kwargs):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out, printed = quietly(fn, *args, **kwargs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        return out, printed, wall_s, {k: c.launches for k, c in counters.items() if c.launches}

    # the fixed duct's compare CLI, as a user runs it: on the card, counted,
    # and on the CPU
    comp, printed, card_s, launches = counted(fixed_compare.run, fixed_argv + other)
    for line in printed.splitlines():
        log(f"  | {line}")
    line = json.loads(printed.strip().splitlines()[-1])
    out_dir = Path(line["dir"])
    if not ((out_dir / "Test.csv").exists() and (out_dir / "Shapiro.csv").exists()):
        fail(f"compare: the CLI wrote no Test.csv and Shapiro.csv under {out_dir}")
    if not all(0 <= v <= 1 for _, _, v in p_values(line)):
        fail(f"compare: a p-value outside [0, 1]: {line}")
    want = {"pointnet_global", "decoder_prop", "sa_neighborhood", "farthest_point_sampling"}
    if not want <= set(launches) or any(k.endswith("_bwd") for k in launches):
        fail(f"compare: the fixed compare launched {launches}; want {sorted(want)} forward "
             f"and no backward")
    t0 = time.perf_counter()
    cpu, _ = quietly(fixed_compare.run, fixed_argv + other, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = check_close("compare fixed card against CPU",
                      [(f"{n} errors", torch.as_tensor(a), torch.as_tensor(b))
                       for n, a, b in zip(comp.names, comp.errors, cpu.errors)])
    # the rank tests as the compare printed them; the tests over the logs
    # over all errors (read), over those above COMPARE_SMALL of their
    # field's largest (read) and over those above the noise floor (held)
    by_family = [{label: v for f, label, v in p_values(c.summary()) if f == family}
                 for family in ("rank", "log") for c in (comp, cpu)]
    gaps = {"rank": p_gap(*by_family[:2], gate=True),
            "log_all": p_gap(*by_family[2:], gate=False)}
    floors = {"small": [COMPARE_SMALL * b.max(axis=0) for b in cpu.errors],
              "noise": [COMPARE_LOG_FLOOR * np.abs(a - b).max(axis=0)
                        for a, b in zip(comp.errors, cpu.errors)]}
    left_out = {}
    for key, floor in floors.items():
        keep = [(a > fl) & (b > fl) for a, b, fl in zip(comp.errors, cpu.errors, floor)]
        left_out[key] = {m: dict(zip(comp.fields, (~k).sum(axis=0).tolist()))
                         for m, k in zip(comp.names, keep)}
        gaps[f"log_above_{key}"] = p_gap(log_tests(comp.errors, keep, comp.fields, comp.names),
                                         log_tests(cpu.errors, keep, comp.fields, comp.names),
                                         gate=key == "noise")
    fixed_ms = comp.summary()["inference_ms_per_case"]
    log(f"compare fixed ({comp.names[0]} vs {comp.names[1]}, {line['cases']} cases at "
        f"{n_int}/{n_bnd}/{n_obs} points, {len(comp.errors[0])} errors a field): "
        f"{card_s:.3f} s in process ({cpu_s:.1f} s on the CPU); launches "
        f"{launches}; inference ms per case {fixed_ms[0]:.3f} / {fixed_ms[1]:.3f}; errors "
        f"within {err:.3e} of the CPU's; p-values, relative to the larger where they differ "
        f"by more than {COMPARE_P_ATOL:.0e}: rank tests within {gaps['rank']:.3e}, log-error "
        f"tests within {gaps['log_all']:.3e} over all errors, {gaps['log_above_small']:.3e} "
        f"over those above {COMPARE_SMALL:.0e} of their field's largest (left out "
        f"{left_out['small']}), {gaps['log_above_noise']:.3e} over those above "
        f"{COMPARE_LOG_FLOOR:.0e} times the card's largest difference (left out "
        f"{left_out['noise']}; noise floors "
        f"{[np.round(f, 9).tolist() for f in floors['noise']]}) ({name}; {smi})")
    report["fixed"] = {"names": list(comp.names), "in_process_s": card_s,
                       "cpu_s": cpu_s, "launches": launches, "inference_ms_per_case": fixed_ms,
                       "errors_max_abs_err": err, "p_value_max_rel_gap": gaps,
                       "log_tests_left_out": left_out,
                       "noise_floors": [f.tolist() for f in floors["noise"]],
                       "summary": comp.summary(), "cpu_summary": cpu.summary()}

    # the variable duct's compare CLI on phase 15's split and checkpoints
    var_logs = variable / "logs" / "lightning_logs"
    var_argv = ["--checkpoint", str(var_logs / CLI_MODELS[0] / "model.ckpt"),
                "--checkpoint-other", str(var_logs / CLI_MODELS[1] / "model.ckpt"),
                "--data-dir", str(variable / "data" / "val"),
                "--meta-dir", str(variable / "data" / "train"), "--n-internal", str(N_INT),
                "--n-boundary", str(N_BND), "--n-observations", str(N_OBS)]
    vcomp, _, var_s, var_launches = counted(var_compare.run, var_argv)
    want = {"neural_ops_prop", "pointnet_global", "sa_neighborhood", "farthest_point_sampling"}
    if not want <= set(var_launches) or any(k.endswith("_bwd") for k in var_launches):
        fail(f"compare: the variable compare launched {var_launches}; want {sorted(want)} "
             f"forward and no backward")
    vline = vcomp.summary()
    if not (finite_numbers(vline["inference_ms_per_case"]) and
            all(0 <= v <= 1 for _, _, v in p_values(vline))):
        fail(f"compare: the variable compare printed {vline}")
    log(f"compare variable ({vcomp.names[0]} vs {vcomp.names[1]}, {vline['cases']} cases at "
        f"{N_INT}/{N_BND}/{N_OBS} points): {var_s:.3f} s in process; launches {var_launches}; "
        f"inference ms per case {vline['inference_ms_per_case'][0]:.3f} / "
        f"{vline['inference_ms_per_case'][1]:.3f} ({name}; {smi})")
    report["variable"] = {"names": list(vcomp.names), "in_process_s": var_s,
                          "launches": var_launches,
                          "inference_ms_per_case": vline["inference_ms_per_case"],
                          "summary": vline}

    # the fixed evaluate CLI's error table, card and CPU
    card_line, _ = quietly(evaluate.run, fixed_argv)
    cpu_line, _ = quietly(evaluate.run, fixed_argv, device="cpu")
    if list(card_line["errors"]) != list(cpu_line["errors"]) or \
            not finite_numbers(card_line["errors"]):
        fail(f"compare: the evaluate CLI's error table {card_line['errors']} against the "
             f"CPU's {cpu_line['errors']}")
    log(f"compare: the fixed evaluate CLI's error table on the card, rows "
        f"{list(card_line['errors'])}: {json.dumps(card_line['errors'])}")
    report["evaluate_errors"] = {"card": card_line["errors"], "cpu": cpu_line["errors"]}

    # --save-plots, with or without matplotlib on this machine
    try:
        import matplotlib
        report["matplotlib"] = matplotlib.__version__
    except ImportError:
        report["matplotlib"] = None
    clis = (("evaluate", evaluate.run, fixed_argv), ("inference", inference.run, fixed_argv),
            ("compare", fixed_compare.run, fixed_argv + other))
    if report["matplotlib"] is None:
        for label, run, argv in clis:
            for c in counters.values():
                c.launches = 0
            try:
                quietly(run, argv + ["--save-plots"])
            except ImportError as e:
                if "matplotlib" not in str(e):
                    fail(f"compare: {label} --save-plots raised {e!r}")
            else:
                fail(f"compare: {label} --save-plots ran without matplotlib")
            launched = {k: c.launches for k, c in counters.items() if c.launches}
            if launched:
                fail(f"compare: {label} --save-plots launched {launched} before refusing")
        log("compare: no matplotlib here; --save-plots raised the ImportError that names it "
            "in the evaluate, inference and compare CLIs, with no launch")
    else:
        for label, run, argv in clis:
            quietly(run, argv + ["--save-plots"])
        plots = fixed_logs / "pipn" / "plots" / "val"
        wanted = [plots / "stats" / "Errors.csv", plots / "stats" / "Pressure drop.png",
                  plots / "case_0" / "Predicted.png", out_dir / "Max error difference.png",
                  out_dir / "Test.csv", out_dir / "Shapiro.csv"]
        missing = [str(p) for p in wanted if not p.exists()]
        if missing:
            fail(f"compare: --save-plots did not write {missing}")
        log(f"compare: matplotlib {report['matplotlib']}; --save-plots wrote the JAX "
            f"package's file names ({len(wanted)} checked)")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"compare: phase 40 took {report['phase_s']:.1f} s ({name}; {smi})")
    return report


# phase 41: the batch of the two-rank steps (13 cases: data shares 7 / 6),
# the steps timed after the compared one, and the CLI's synthetic split
MR_CASES, MR_TIMED = BATCH, 3
MR_SPLIT = (8, 4, 400, 60)          # train cases, val cases, internal points, per patch
MR_POINTS = (240, 120, 60)
MR_DIST = (N_INT + N_BND, N_BND)    # min_distance: all of a case's rows to its boundary


def _mr_model(device):
    from porous_cfd_tpu_torch.data.synthetic import make_scalers
    from porous_cfd_tpu_torch.models.pipn import pipn_foam
    import torch
    return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, make_scalers(), seg_dropout=SEG_DROPOUT,
                     generator=torch.Generator().manual_seed(SEED), device=device)


def _mr_step(mesh, shard_points, counters):
    """One counted training step of the full-width pipn on the phase's
    batch (this rank's share of it with a mesh), then MR_TIMED timed ones:
    (metrics, gradients and parameters after the first step, its launches,
    ms a step)."""
    import torch
    from porous_cfd_tpu_torch.data.synthetic import make_foam_batch
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    dev = torch.device("cuda", 0)
    model = _mr_model(dev)
    batch = make_foam_batch(MR_CASES, N_INT, N_BND, N_OBS, seed=SEED + 41).to(dev)
    fns = make_train_functions(model, make_optimizer(model, 1), FixedLossScaler(LOSS_WEIGHTS),
                               mesh=mesh, shard_points=shard_points)
    state = fns.init_state(seed=SEED)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    state, metrics = fns.train_step(state, batch)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    params = list(model.module.parameters())
    first = (metrics.cpu(), [p.grad.cpu() for p in params], [p.detach().cpu() for p in params])
    t0 = time.perf_counter()
    for _ in range(MR_TIMED):
        state, _ = fns.train_step(state, batch)
    torch.cuda.synchronize()
    return first, launches, (time.perf_counter() - t0) * 1e3 / MR_TIMED


# phase 41's points-split paths, each at its own phase's full width and
# batch: label -> (cases, (internal, boundary, observation) points, batch
# kind, loss weights, one step's launches). The exact U-Net takes
# MR_UNET_EXACT_CASES cases, in micro-batches of 1 (3 is odd): its own
# phase's 4 cases step in groups of 2, 41 GB a process, and two ranks with
# the encoder whole on each would not fit 80 GB
MR_UNET_EXACT_CASES = 3
_MR_FOAM = (N_INT, N_BND, N_OBS)
_MR_PIPN = dict(pointnet_global=1, pointnet_global_bwd=1, decoder_prop=2, decoder_prop_bwd=2)
_MR_COUPLED = dict(_MR_PIPN, decoder_prop_j0_add=1, decoder_prop_j0_add_bwd=1)
_MR_PP = dict(_MR_PIPN, sa_neighborhood=2, sa_neighborhood_bwd=2)
_MR_GANO = dict(pointnet_global=2, pointnet_global_bwd=2, neural_ops_prop=2,
                neural_ops_prop_bwd=2)
MR_PATHS = {
    "pipn_coupled": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS, _MR_COUPLED),
    "pipn_exact": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS, {}),
    "pipn_pp": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS, _MR_PP),
    "pipn_pp_exact": (EXACT_CASES, _MR_FOAM, "foam", LOSS_WEIGHTS, {}),
    "pipn_pp_mrg": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS,
                    dict(_MR_PIPN, sa_neighborhood=3, sa_neighborhood_bwd=3, pointnet_global=2,
                         pointnet_global_bwd=2)),
    "pipn_pp_full": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS,
                     dict(sa_neighborhood=2, sa_neighborhood_bwd=2, pointnet_global=1,
                          pointnet_global_bwd=1)),
    "pipn_pp_full_exact": (MR_UNET_EXACT_CASES, _MR_FOAM, "foam", LOSS_WEIGHTS, {}),
    "pi_gano": (EXACT_CASES, _MR_FOAM, "foam", LOSS_WEIGHTS, {}),
    "pi_gano_fast": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS, _MR_GANO),
    "pi_gano_full": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS,
                     dict(_MR_GANO, neural_ops_prop=6, neural_ops_prop_bwd=6,
                          neural_ops_prop_full=6, neural_ops_prop_full_bwd=6)),
    "pi_gano_pp": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS,
                   dict(_MR_GANO, sa_neighborhood=2, sa_neighborhood_bwd=2)),
    "pi_gano_pp_full": (BATCH, _MR_FOAM, "foam", LOSS_WEIGHTS,
                        dict(sa_neighborhood=2, sa_neighborhood_bwd=2, pointnet_global=2,
                             pointnet_global_bwd=2)),
    "manufactured": (MS_BATCH, (MS_INT, MS_BND, 0), "manufactured", (1,) * 6, {}),
    "manufactured_coupled": (MS_BATCH, (MS_INT, MS_BND, 0), "manufactured", (1,) * 6,
                             _MR_COUPLED),
    "manufactured_pp": (BATCH, (MSP_INT, MSP_BND, 0), "manufactured", MSP_WEIGHTS, _MR_PP),
    "abc_pipn_pp": (BATCH, _MR_FOAM, "abc", ABC_WEIGHTS, _MR_PP),
    "windbreaks_pi_gano": (BATCH, _MR_FOAM, "windbreaks", WB_WEIGHTS, _MR_GANO),
}
# timed steps of each path after its counted one
MR_PATH_TIMED = 2
# the U-Nets' gradients, two ranks against one process on the card: the
# card's own tolerance of their max-pooled encoders (UNET_POOLED_RTOL)
MR_UNETS = ("pipn_pp_full", "pipn_pp_full_exact", "pi_gano_pp_full")


def _mr_build(path, device):
    """The full-width model of a phase-41 path on ``device``, as its own
    phase builds it (the U-Nets and the 3D models through the CLIs'
    get_model)."""
    import torch
    from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_scalers,
                                                     make_scalers_3d)
    from porous_cfd_tpu_torch.examples.abc import train as abc_train
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
    from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable_train
    from porous_cfd_tpu_torch.examples.windbreaks import train as wb_train
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp
    from porous_cfd_tpu_torch.models.pipn import (pipn_foam, pipn_foam_pp, pipn_foam_pp_mrg,
                                                  pipn_manufactured, pipn_manufactured_pp)
    sc = make_scalers()
    kw = dict(generator=torch.Generator().manual_seed(SEED), device=device)

    def gano(fast, full=False):
        return pi_gano(NU, 3, PG_BRANCH, PG_GEOMETRY, PG_LOCAL, PG_OPERATORS, PG_DROPOUT, sc,
                       VARIABLE_BOUNDARIES, full=full, fast_derivatives=fast, **kw)

    def pp(fast):
        return pipn_foam_pp(NU, D, F, PP_LOCAL, PP_GLOBAL, PP_RADIUS, PP_FRACTION, PP_SEG, sc,
                            seg_dropout=PP_DROPOUT, max_neighbors=PP_NEIGHBORS,
                            fast_derivatives=fast, **kw)

    factories = {
        "pipn_coupled": lambda: pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, sc,
                                          seg_dropout=SEG_DROPOUT, coupled_context=True, **kw),
        "pipn_exact": lambda: pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, sc,
                                        seg_dropout=SEG_DROPOUT, fast_derivatives=False, **kw),
        "pipn_pp": lambda: pp(True),
        "pipn_pp_exact": lambda: pp(False),
        "pipn_pp_mrg": lambda: pipn_foam_pp_mrg(2, MRG_IN, NU, D, F, MRG_LOCAL, MRG_SEG, sc,
                                                seg_dropout=MRG_DROPOUT,
                                                max_neighbors=PP_NEIGHBORS, **kw),
        "pipn_pp_full": lambda: fixed_train.get_model(Namespace(model="pipn-pp-full"), sc,
                                                      device, True),
        "pipn_pp_full_exact": lambda: fixed_train.get_model(Namespace(model="pipn-pp-full"),
                                                            sc, device, False),
        "pi_gano": lambda: gano(False),
        "pi_gano_fast": lambda: gano(True),
        "pi_gano_full": lambda: gano(True, full=True),
        "pi_gano_pp": lambda: pi_gano_pp(NU, 3, PG_BRANCH, PGP_GEOMETRY, PGP_RADIUS,
                                         PGP_FRACTION, PG_LOCAL, PG_OPERATORS, PG_DROPOUT, sc,
                                         VARIABLE_BOUNDARIES, max_neighbors=PGP_NEIGHBORS, **kw),
        "pi_gano_pp_full": lambda: variable_train.get_model(
            Namespace(model="pi-gano-pp-full"), sc, device, True),
        "manufactured": lambda: pipn_manufactured(0.01, 50.0, 1.0, FE_LOCAL, MS_FE_GLOBAL, SEG,
                                                  **kw),
        "manufactured_coupled": lambda: pipn_manufactured(0.01, 50.0, 1.0, FE_LOCAL,
                                                          MS_FE_GLOBAL, SEG,
                                                          fast_derivatives=True, **kw),
        "manufactured_pp": lambda: pipn_manufactured_pp(0.01, 50.0, 1.0, MSP_LOCAL, MSP_GLOBAL,
                                                        MSP_RADIUS, MSP_FRACTION, MSP_SEG,
                                                        max_neighbors=MSP_NEIGHBORS, **kw),
        "abc_pipn_pp": lambda: abc_train.get_model(Namespace(model="pipn-pp"),
                                                   make_scalers_3d(), device),
        "windbreaks_pi_gano": lambda: wb_train.get_model(Namespace(model="pi-gano"),
                                                         make_scalers_3d(), device),
    }
    return factories[path]()


def _mr_batch(kind, cases, points):
    """A phase-41 path's batch (CPU tensors) of ``kind``, from seed
    SEED + 41."""
    import numpy as np
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    from porous_cfd_tpu_torch.data.synthetic import (PATCHES_3D, make_foam_batch,
                                                     make_foam_batch_3d)
    if kind == "manufactured":
        return make_manufactured_batch(np.random.default_rng(SEED + 41), cases, *points[:2])
    if kind in PATCHES_3D:
        return make_foam_batch_3d(cases, *points, PATCHES_3D[kind], seed=SEED + 41)
    return make_foam_batch(cases, *points, seed=SEED + 41)


def _record_rows(rows):
    """Wrap the entry points of the (v, J, H) kernels and of the U-Nets'
    last FP level so that each call appends (its name, its internal rows,
    its boundary rows) to ``rows``; the wrapped functions count their
    launches as before."""
    from porous_cfd_tpu_torch.ops import decoder_cuda, neural_op_cuda
    from porous_cfd_tpu_torch.physics import analytic

    def wrap(module, name, rows_of):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            rows.append((name, *rows_of(*args)))
            return fn(*args, **kwargs)
        setattr(module, name, wrapped)

    # decoder_prop(linears, n_local, v, jt, ht, v_b, ...) and
    # neural_ops_prop(operators, reduction, n_local, v, jt, ht, v_b, ...)
    wrap(decoder_cuda, "decoder_prop", lambda *a: (a[2].shape[-2], a[5].shape[-2]))
    wrap(neural_op_cuda, "neural_ops_prop", lambda *a: (a[3].shape[-2], a[6].shape[-2]))
    wrap(analytic, "mlp_prop_merged", lambda _linears, v, _j, _h, n_int, *a:
         (n_int, v.shape[-2] - n_int))


def _mr_path_step(path, mesh, counters, rows, device="cuda:0"):
    """One counted training step of a phase-41 path on its batch (this
    rank's points share with a mesh), then MR_PATH_TIMED timed ones: the
    metrics, gradients and parameters after the first step (with the
    parameters' names and Adam's lr and eps), its launches, its (v, J, H)
    calls' rows, ms a step and the peak bytes allocated."""
    import torch
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    dev = torch.device(device)
    cases, points, kind, weights, _ = MR_PATHS[path]
    model = _mr_build(path, dev)
    batch = model.attach_neighbors(_mr_batch(kind, cases, points).to(dev))
    fns = make_train_functions(model, make_optimizer(model, 1), FixedLossScaler(weights),
                               mesh=mesh, shard_points=mesh is not None)
    state = fns.init_state(seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    rows.clear()
    state, metrics = fns.train_step(state, batch)
    torch.cuda.synchronize()
    named = list(model.module.named_parameters())
    out = {"launches": {k: c.launches for k, c in counters.items()}, "rows": list(rows),
           "metrics": metrics.cpu(), "names": [n for n, _ in named],
           "grads": [p.grad.cpu() for _, p in named],
           "params": [p.detach().cpu() for _, p in named],
           "adam": (model.learning_rate, model.adam_eps)}
    t0 = time.perf_counter()
    for _ in range(MR_PATH_TIMED):
        state, _ = fns.train_step(state, batch)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3 / MR_PATH_TIMED
    out["peak"] = torch.cuda.max_memory_allocated()
    del model, batch, fns, state
    torch.cuda.empty_cache()
    return out


def _mr_clouds(device):
    """The min_distance check's query and target clouds (MR_DIST) on
    ``device``."""
    import torch
    gen = torch.Generator().manual_seed(SEED)
    q, tgt = torch.rand((MR_DIST[0], 2), generator=gen), torch.rand((MR_DIST[1], 2),
                                                                       generator=gen)
    return q.to(device), tgt.to(device)


def _mr_worker(rank, world, init_method, out):
    """A rank of phase 41: both meshes on cuda:0, one step each, then each
    path of MR_PATHS on the points mesh."""
    import os
    import torch
    sys.path.insert(0, str(ROOT))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from porous_cfd_tpu_torch.parallel.mesh import make_mesh
    from porous_cfd_tpu_torch.ops import distance
    counters = kernel_counters()
    res = {}
    try:
        for label, shape in (("data", (2, 1)), ("points", (1, 2))):
            mesh = make_mesh(*shape, devices=["cuda:0"] * world, init_method=init_method)
            res[label] = _mr_step(mesh, shape[1] > 1, counters)
            res["backend"] = mesh.backend
        # every other family and path with its rows split over the points mesh
        rows = []
        _record_rows(rows)
        res["paths"] = {path: _mr_path_step(path, mesh, counters, rows) for path in MR_PATHS}
        # every collective the port calls, on CUDA tensors through the
        # points mesh's backend, and the points-split min_distance
        dev = torch.device("cuda", 0)
        t = torch.tensor([rank + 1.0, 5.0 - rank], device=dev)
        res["collectives"] = {
            **{op: mesh.all_reduce(t.clone(), op, "points").tolist()
               for op in ("sum", "max", "min")},
            "min_int64": mesh.all_reduce(torch.tensor([rank + 3], device=dev), "min",
                                         "points").tolist(),
            "all_gather": [x.tolist() for x in mesh.all_gather(t, "points")]}
        res["min_distance_sharded"] = distance.min_distance_sharded(*_mr_clouds(dev),
                                                                    mesh).cpu()
        torch.save(res, f"{out}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


def multi_rank_phase(name, smi, counters):
    """Phase 41 (module docstring): the two-rank steps against one process,
    the CLI at --mesh-data 1 under NCCL, min_distance against float64."""
    import contextlib
    import io
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.datagen import synthetic_case
    from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train
    from porous_cfd_tpu_torch.ops import distance
    from porous_cfd_tpu_torch.parallel.mesh import share
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    report = {"cases": MR_CASES, "points": [N_INT, N_BND, N_OBS], "ranks": 2}
    want = {k: 0 for k in counters} | dict(pointnet_global=1, pointnet_global_bwd=1,
                                           decoder_prop=2, decoder_prop_bwd=2)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rank"
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_mr_worker, args=(2, f"file://{tmp}/store", out), nprocs=2,
                                    join=True)
        report["ranks_wall_s"] = time.perf_counter() - t0
        ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    (ref_m, ref_g, ref_p), ref_launches, ref_ms = _mr_step(None, False, counters)
    if ref_launches != want:
        fail(f"multi-rank: one process's step launched {ref_launches}, not {want}")
    model = _mr_model("cpu")
    lr, eps = model.learning_rate, model.adam_eps
    pnames = [n for n, _ in model.module.named_parameters()]
    report["backend"], report["one_process_ms_per_step"] = ranks[0]["backend"], ref_ms
    want_coll = {"sum": [3.0, 9.0], "max": [2.0, 5.0], "min": [1.0, 4.0], "min_int64": [3],
                 "all_gather": [[1.0, 5.0], [2.0, 4.0]]}
    for rank, res in enumerate(ranks):
        if res["collectives"] != want_coll:
            fail(f"multi-rank: rank {rank}'s collectives on CUDA tensors gave "
                 f"{res['collectives']}, not {want_coll}")
    log(f"  multi-rank: {report['backend']} on CUDA tensors, both ranks: all_reduce sum, max, "
        "min (f32, int64) and all_gather give the expected values")
    log(f"multi-rank: 2 ranks on cuda:0, backend {report['backend']}, {MR_CASES} cases of "
        f"{N_INT}/{N_BND}/{N_OBS} points, full-width pipn with dropout; one process "
        f"{ref_ms:.3f} ms a step")
    for label in ("data", "points"):
        for rank, res in enumerate(ranks):
            (m, g, prm), launches, ms = res[label]
            tag = f"multi-rank {label} rank {rank}"
            log(f"  {tag}: launches {({k: v for k, v in launches.items() if v})}, "
                f"{ms:.3f} ms a step (two ranks sharing the card)")
            if launches != want:
                fail(f"{tag}: launches {launches} != {want}")
            if rank and not torch.equal(m, ranks[0][label][0][0]):
                fail(f"{tag}: metrics differ from rank 0's")
            # each metric against its own magnitude: the weighted total
            # dwarfs the errors
            check_close(f"{tag} vs one process metrics",
                        [(f"metric {i}", m[i:i + 1], ref_m[i:i + 1]) for i in range(len(ref_m))],
                        quiet=True)
            check_close(f"{tag} vs one process gradients",
                        [(f"grad {n}", a, r) for n, a, r in zip(pnames, g, ref_g)], quiet=True)
            for n, a, r, gr in zip(pnames, prm, ref_p, ref_g):
                spread = adam_first_step_spread(gr, RTOL * float(gr.abs().max()), lr, eps)
                if bool(((a.double() - r.double()).abs()
                         > RTOL * float(r.abs().max()) + spread).any()):
                    fail(f"{tag}: parameter {n} differs from one process's")
            report[f"{label}_rank{rank}"] = {"launches": {k: v for k, v in launches.items() if v},
                                             "ms_per_step": ms,
                                             "metrics_max_err": float((m - ref_m).abs().max())}
        log(f"  multi-rank {label}: both ranks' metrics, gradients and updated parameters "
            "agree with one process's")

    # every other family and path with its rows split over the two ranks:
    # each rank's step against one process's on the card, its launches, and
    # the rows of its (v, J, H) calls (the share's, never the whole cloud's)
    report["paths"] = {}
    for path, (cases, points, kind, weights, want_path) in MR_PATHS.items():
        want_p = {k: 0 for k in counters} | want_path
        ref = _mr_path_step(path, None, counters, [])
        if ref["launches"] != want_p:
            fail(f"multi-rank {path}: one process's step launched {ref['launches']}, not "
                 f"{want_p}")
        lr, eps = ref["adam"]
        rtol_g = UNET_POOLED_RTOL if path in MR_UNETS else RTOL
        entry = {"cases": cases, "points": list(points), "kind": kind,
                 "one_process": {"ms_per_step": ref["ms"], "peak_bytes": ref["peak"]}}
        for rank, res in enumerate(ranks):
            got = res["paths"][path]
            tag = f"multi-rank points {path} rank {rank}"
            if got["launches"] != want_p:
                fail(f"{tag}: launches {got['launches']} != {want_p}")
            share_rows = tuple(b - a for a, b in (share(points[0], 2, rank),
                                                  share(points[1], 2, rank)))
            if (bool(want_path) != bool(got["rows"])
                    or any(tuple(r[1:]) != share_rows for r in got["rows"])):
                fail(f"{tag}: (v, J, H) calls on rows {got['rows']}, not the share's "
                     f"{share_rows}")
            if rank and not torch.equal(got["metrics"], ranks[0]["paths"][path]["metrics"]):
                fail(f"{tag}: metrics differ from rank 0's")
            m, ref_m = got["metrics"], ref["metrics"]
            check_close(f"{tag} vs one process metrics",
                        [(f"metric {i}", m[i:i + 1], ref_m[i:i + 1]) for i in range(len(ref_m))],
                        quiet=True)
            pairs = list(zip(ref["names"], got["grads"], ref["grads"]))
            check_close(f"{tag} vs one process gradients",
                        [(f"grad {n}", a, r) for n, a, r in pairs], quiet=True,
                        rtol={f"grad {n}": rtol_g for n, _, _ in pairs})
            for n, a, r, gr in zip(ref["names"], got["params"], ref["params"], ref["grads"]):
                spread = adam_first_step_spread(gr, rtol_g * float(gr.abs().max()), lr, eps)
                if bool(((a.double() - r.double()).abs()
                         > RTOL * float(r.abs().max()) + spread).any()):
                    fail(f"{tag}: parameter {n} differs from one process's")
            entry[f"rank{rank}"] = {"launches": {k: v for k, v in got["launches"].items() if v},
                                    "rows": sorted(set(r[1:] for r in got["rows"])),
                                    "ms_per_step": got["ms"], "peak_bytes": got["peak"],
                                    "metrics_max_err": float((m - ref_m).abs().max())}
            log(f"  {tag}: launches {entry[f'rank{rank}']['launches']}, (v, J, H) rows "
                f"{entry[f'rank{rank}']['rows']}, {got['ms']:.3f} ms a step, peak "
                f"{got['peak'] / 2**30:.2f} GiB (two ranks sharing the card)")
        log(f"  multi-rank points {path}: {cases} cases of {points}; one process "
            f"{ref['ms']:.3f} ms a step, peak {ref['peak'] / 2**30:.2f} GiB; both ranks' "
            f"metrics, gradients and updated parameters agree with it ({name}; {smi})")
        report["paths"][path] = entry
        torch.cuda.empty_cache()

    # the CLI at --mesh-data 1: a process group of one, NCCL on the card
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        rng = np.random.default_rng(SEED)
        fields = ["C", "U", "p", "cellToRegion"]
        n_train, n_val, n_int, per_patch = MR_SPLIT
        for split, n in (("train", n_train), ("val", n_val)):
            synthetic_case.write_foam_split(root / split, n, rng, n_internal=n_int,
                                            n_per_patch=per_patch)
            synthetic_case.write_data_config(root / split, fields, {},
                                             {"Scale": [], "Standardize": ["C", "U", "p"]},
                                             ["x", "y"])
            generate_meta(root / split, *fields, max_dim=2)
        generate_min_points(root)
        argv = ["--model", "pipn", "--name", "mesh1", "--epochs", "2", "--batch-size", "4",
                "--n-internal", str(MR_POINTS[0]), "--n-boundary", str(MR_POINTS[1]),
                "--n-observations", str(MR_POINTS[2]), "--train-dir", str(root / "train"),
                "--val-dir", str(root / "val"), "--logs-dir", str(Path(tmp) / "logs"),
                "--mesh-data", "1"]
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train.run(argv)
        torch.cuda.synchronize()
        report["cli_wall_s"] = time.perf_counter() - t0
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        log(f"  multi-rank cli --mesh-data 1: {report['cli_wall_s']:.1f} s, launches {launches}")
        if "backend nccl" not in printed.getvalue():
            fail("multi-rank cli: --mesh-data 1 did not train under NCCL")
        if not all(launches.get(k) for k in ("pointnet_global", "decoder_prop",
                                              "pointnet_global_bwd", "decoder_prop_bwd")):
            fail(f"multi-rank cli: launches {launches}")
        ckpt = torch.load(Path(tmp) / "logs" / "lightning_logs" / "mesh1" / "model.ckpt",
                          weights_only=True)
        if ckpt["epoch"] != 2 or not all(bool(v.isfinite().all())
                                         for v in ckpt["module"].values()):
            fail("multi-rank cli: the checkpoint is not a finite epoch-2 state")
        if torch.distributed.is_initialized():
            fail("multi-rank cli: the process group outlived the run")
        report["cli_launches"] = launches

    # min_distance on the card against the CPU's float64
    q_dev, tgt_dev = _mr_clouds(dev)
    on_card = distance.min_distance(q_dev, tgt_dev)
    ms = time_ms(torch, lambda: distance.min_distance(q_dev, tgt_dev), n=5)
    ref = distance.min_distance(q_dev.cpu(), tgt_dev.cpu())
    err = float((on_card.cpu() - ref).abs().max())
    err_split = max(float((r["min_distance_sharded"] - ref).abs().max()) for r in ranks)
    log(f"  min_distance {MR_DIST[0]} x {MR_DIST[1]} on the card: max|err| {err:.3e} against "
        f"the CPU's float64, {ms:.3f} ms; split over the two ranks' points axis, max|err| "
        f"{err_split:.3e} ({name}; {smi})")
    if on_card.device != dev or on_card.dtype != torch.float64 or max(err, err_split) > 1e-12:
        fail(f"min_distance on the card: {on_card.device} {on_card.dtype}, max|err| {err}, "
             f"split {err_split}")
    report["min_distance"] = {"shape": list(MR_DIST), "max_abs_err": err,
                              "split_max_abs_err": err_split, "ms": ms}
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"multi-rank phase: {report['phase_s']:.1f} s ({name}; {smi})")
    return report


# phase 42: the kernels each tool's run must launch (FPS runs in
# attach_neighbors)
TOOL_KERNELS = {
    "pipn": ("pointnet_global", "decoder_prop"),
    "pipn_pp": ("sa_neighborhood", "farthest_point_sampling"),
    "pi_gano": ("neural_ops_prop", "pointnet_global"),
}
TOOL_DEVICE_SLACK = 1.05       # a piece's device ms against its wall ms
TOOL_FLOP_RTOL = 5e-3          # roofline's decoder FLOPs against phase 3's


def _numbers(obj, path=""):
    """(path, value) of every number in a parsed JSON line (not bools)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _numbers(v, f"{path}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _numbers(v, f"{path}/{i}")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def tools_phase(name, smi, counters, decoder_flop):
    """Phase 42 (module docstring): every measurement tool in process on the
    card; ``decoder_flop`` is phase 3's FLOP count of pipn's decoder_prop
    forward."""
    import contextlib
    import io
    import torch
    from porous_cfd_tpu_torch.tools import (make_mesh_assets, measure_full_rates, mfu,
                                            profile_delta, profile_gano, profile_pp,
                                            profile_step, render_smoke, roofline,
                                            samehost_ratio, torch_baseline)
    t_phase = time.perf_counter()
    report = {}

    def run_tool(label, fn, want=()):
        """Run one tool with every launch count at 0; its printed line parsed
        and checked; the kernels ``want`` launched."""
        for c in counters.values():
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        printed = buf.getvalue().strip().splitlines()
        try:
            line = json.loads(printed[-1])
        except (IndexError, json.JSONDecodeError) as e:
            fail(f"tools: {label} printed no JSON line ({e}): {printed[-3:]}")
        bad = [(p, v) for p, v in _numbers(line) if not (math.isfinite(v) and v > 0)]
        if bad:
            fail(f"tools: {label}: numbers not finite and positive: {bad[:5]}")
        if line.get("card") != smi:
            fail(f"tools: {label}: card {line.get('card')!r} is not {smi!r}")
        missing = [k for k in want if not launches.get(k)]
        if missing:
            fail(f"tools: {label} launched no {missing} (launches {launches})")
        for piece, t in line.get("pieces", {}).items():
            if not t["device_ms"] <= TOOL_DEVICE_SLACK * t["wall_ms"]:
                fail(f"tools: {label} {piece}: device {t['device_ms']:.4f} ms > wall "
                     f"{t['wall_ms']:.4f} ms + 5%")
        retried = [p for p, t in line.get("pieces", {}).items() if t["profiled_windows"] > 1]
        log(f"tools: {label}: {seconds:.1f} s, launches {launches}"
            + (f"; profiled again (a window without device time): {retried}" if retried else ""))
        log(json.dumps({f"tool_{label}": line}))
        report[label] = {"s": seconds, "launches": launches, "line": line}
        torch.cuda.empty_cache()
        return line

    step_line = run_tool("profile_step", lambda: profile_step.run(["--family", "pipn"]),
                         TOOL_KERNELS["pipn"])
    pp_line = run_tool("profile_pp", lambda: profile_pp.run(["--family", "pipn_pp"]),
                       TOOL_KERNELS["pipn_pp"])
    measured = {"pipn": step_line["train_steps_per_sec"],
                "pipn_pp": pp_line["train_steps_per_sec"]}
    roof = run_tool("roofline", lambda: roofline.run(["--families", "pipn,pipn_pp",
                                                      "--measured", json.dumps(measured)]))
    mfu_line = run_tool("mfu", lambda: mfu.run(["--families", "pipn,pi_gano"]),
                        TOOL_KERNELS["pipn"] + TOOL_KERNELS["pi_gano"])
    run_tool("profile_gano", lambda: profile_gano.run([]), TOOL_KERNELS["pi_gano"])
    for family in ("pipn", "pipn_pp", "pi_gano"):
        run_tool(f"profile_delta_{family}", lambda f=family: profile_delta.run(["--family", f]),
                 TOOL_KERNELS[family])
    run_tool("measure_full_rates", lambda: measure_full_rates.run(["--steps", "2"]),
             ("sa_neighborhood", "pointnet_global", "farthest_point_sampling"))
    run_tool("torch_baseline", lambda: torch_baseline.run(["--steps", "2"]))
    run_tool("samehost_ratio", lambda: samehost_ratio.run(["--torch-steps", "2"]),
             TOOL_KERNELS["pipn"])

    # the shares of a peak
    shares = [(f"mfu {f} {k}", r[k], 1.0) for f, r in mfu_line["families"].items()
              for k in ("mfu_vs_f32_peak", "mfu_vs_bf16_peak")]
    shares += [(f"profile_step {k}", step_line[k], 100.0)
               for k in ("mfu_vs_f32_peak_pct", "mfu_vs_tf32_peak_pct")]
    shares += [(f"roofline {f} pct_of_matmul_peak", e["pct_of_matmul_peak"], 100.0)
               for f, e in roof["per_family"].items()]
    for label, value, top in shares:
        if not 0 < value <= top:
            fail(f"tools: {label} = {value} is not in (0, {top:g}]")
    # roofline's pipn decoder forward against phase 3's count for the same launch
    flop = roof["per_family"]["pipn"]["decoder_fwd_gflops"] * 1e9
    if abs(flop / decoder_flop - 1) > TOOL_FLOP_RTOL:
        fail(f"tools: roofline's pipn decoder forward {flop:.6e} FLOP is not phase 3's "
             f"{decoder_flop:.6e} within {TOOL_FLOP_RTOL}")
    log(f"tools: roofline's pipn decoder forward {flop / 1e9:.3f} GFLOP, phase 3's "
        f"{decoder_flop / 1e9:.3f}")

    # the mesh assets and the render smoke, into a temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = make_mesh_assets.main([f"{tmp}/meshes"])
        standard = ROOT / "examples/duct_fixed_boundary/assets/meshes/standard"
        checked_in = sorted(standard.glob("*.obj"))
        if (len(paths) != 11 or sorted(p.name for p in paths) != [p.name for p in checked_in]
                or any(p.read_bytes() != (standard / p.name).read_bytes() for p in paths)):
            fail("tools: make_mesh_assets did not write the 11 checked-in OBJ files")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = render_smoke.main(["--out", f"{tmp}/render"])
        lines = buf.getvalue().strip().splitlines()
        if rc != 0 or [line.split(":")[0] for line in lines] != ["pyvista", "bpy"] or not all(
                ": SKIP" in line for line in lines):
            fail(f"tools: render_smoke rc {rc}, lines {lines}")
    log("tools: make_mesh_assets wrote the 11 checked-in OBJ files; render_smoke: "
        + "; ".join(lines))
    report["render_smoke"] = lines
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"tools phase: {report['phase_s']:.1f} s ({name}; {smi})")
    return report


def kernel_counters() -> dict:
    """Every kernel wrapper's launch count (and each engine mode's), by the
    key the kernels line uses."""
    from porous_cfd_tpu_torch.ops import (decoder_cuda, fps_cuda, neural_op_cuda, pointnet_cuda,
                                          sa_cuda)
    counters = {"pointnet_global": pointnet_cuda.pointnet_global,
                "pointnet_global_bwd": pointnet_cuda.pointnet_global_backward,
                "decoder_prop": decoder_cuda.decoder_prop,
                "decoder_prop_bwd": decoder_cuda.decoder_prop_backward,
                "neural_ops_prop": neural_op_cuda.neural_ops_prop,
                "neural_ops_prop_bwd": neural_op_cuda.neural_ops_prop_backward,
                "sa_neighborhood": sa_cuda.sa_neighborhood,
                "sa_neighborhood_bwd": sa_cuda.sa_neighborhood_backward,
                "farthest_point_sampling": fps_cuda.farthest_point_sampling,
                "decoder_prop_j0_add": decoder_cuda.MODE_COUNTS["j0_add"][0],
                "decoder_prop_j0_add_bwd": decoder_cuda.MODE_COUNTS["j0_add"][1],
                "decoder_prop_ctx": decoder_cuda.MODE_COUNTS["ctx_width"][0],
                "decoder_prop_ctx_bwd": decoder_cuda.MODE_COUNTS["ctx_width"][1]}
    for key, mode in (("full", "linear_last_no_reduction"), ("linear_last", "linear_last"),
                      ("no_reduction", "no_reduction")):
        counters[f"neural_ops_prop_{key}"] = neural_op_cuda.MODE_COUNTS[mode][0]
        counters[f"neural_ops_prop_{key}_bwd"] = neural_op_cuda.MODE_COUNTS[mode][1]
    return counters


def main() -> int:
    if not (ROOT / "porous_cfd_tpu_torch").is_dir():
        print("chip_smoke: porous_cfd_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                     make_scalers)
    from porous_cfd_tpu_torch.models.neighbors import fps_count
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
    from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable_train
    from porous_cfd_tpu_torch.models.pipn import (pipn_foam, pipn_foam_pp, pipn_foam_pp_mrg,
                                                  pipn_manufactured_pp)
    from porous_cfd_tpu_torch.ops import (build, decoder_cuda, dropout, fps_cuda,
                                          mlp_prop_cuda, neural_op_cuda, pointnet_cuda,
                                          sa_cuda)
    from porous_cfd_tpu_torch.train.engine import gather_cases

    counters = kernel_counters()
    t_main = time.perf_counter()

    def clock(phase):
        """Log the seconds since the start of main as ``phase`` begins."""
        log(f"[clock] phase {phase} starts at {time.perf_counter() - t_main:.1f} s")

    def counts(**nonzero):
        return {k: nonzero.get(k, 0) for k in counters}

    # ---- 1. device ---------------------------------------------------------
    clock("1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    pk = peaks(name)
    log(f"device: {name} (count {torch.cuda.device_count()}); torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    log(f"peaks used for bounds: {pk[2] / 3e12:.1f} TFLOP/s f32-accurate on the tensor cores "
        f"(3xTF32 of {pk[2] / 1e12:.1f} TF32), {pk[0] / 1e12:.1f} TFLOP/s f32 CUDA cores, "
        f"{pk[1] / 1e12:.2f} TB/s")

    # ---- 2. build ----------------------------------------------------------
    clock("2")
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for src in build.SOURCES:
        report = build.library_path(src).with_suffix(".log")
        if report.exists():
            text = report.read_text()
            for line in text.splitlines():
                if "spill" in line and "0 bytes spill stores" not in line:
                    log(f"  ptxas {src}: {line.strip()}")
            for fam, r in kernel_report(text).items():
                log(f"  ptxas {src} {fam}: {r['count']} instantiations, registers "
                    f"{min(r['registers'])}-{max(r['registers'])}, stack frame <= {r['stack']} "
                    f"B, spill stores <= {r['spill_stores']} B, loads <= {r['spill_loads']} B")
    # blocks per SM of the engine's row kernels and weight_grad at the paths' widths
    for label, kern, widths, kw in (
            ("decoder_prop pipn", decoder_cuda.DECODER, [FE_LOCAL[-1]] + SEG[1:], {}),
            ("decoder_prop pipn_pp", decoder_cuda.DECODER, [FE_LOCAL[-1]] + PP_SEG[1:], {}),
            ("neural_ops_prop pi-gano", neural_op_cuda.TRUNK,
             [PG_LOCAL[-1]] + [PG_BRANCH[-1]] * PG_OPERATORS + [3], {}),
            ("neural_ops_prop pi-gano-full", neural_op_cuda.TRUNK,
             [PG_LOCAL[-1]] + [PG_BRANCH[-1]] * PG_OPERATORS, {"reduction": False})):
        occ = mlp_prop_cuda.occupancy(kern, widths, **kw)
        log(f"  occupancy {label} {widths}: " + ", ".join(f"{k} {v}" for k, v in occ.items()))
        if min(occ["fwd_blocks_per_sm"], occ["bwd_blocks_per_sm"],
               occ["weight_grad_blocks_per_sm"]) < 1:
            fail(f"{label}: a kernel fits no block on an SM ({occ})")
    # and at D = 3 (4 points, 28 rows a block): the 3D experiments' launches
    # and the 2D paths' widths
    for label, kern, widths in (
            ("decoder_prop abc pipn", decoder_cuda.DECODER, [64, 512, 256, 128, 4]),
            ("decoder_prop abc pipn-pp", decoder_cuda.DECODER, [64, 384, 128, 4]),
            ("neural_ops_prop windbreaks", neural_op_cuda.TRUNK, [256] + [512] * 4 + [4]),
            ("decoder_prop pipn's widths", decoder_cuda.DECODER, [FE_LOCAL[-1]] + SEG[1:]),
            ("neural_ops_prop pi-gano's widths", neural_op_cuda.TRUNK,
             [PG_LOCAL[-1]] + [PG_BRANCH[-1]] * PG_OPERATORS + [3])):
        occ = mlp_prop_cuda.occupancy(kern, widths, d_dims=3)
        log(f"  occupancy at D = 3 {label} {widths}: "
            + ", ".join(f"{k} {v}" for k, v in occ.items()))
        if min(occ["fwd_blocks_per_sm"], occ["bwd_blocks_per_sm"]) < 1:
            fail(f"{label} at D = 3: a kernel fits no block on an SM ({occ})")

    # pointnet_global's blocks at the five shapes of phase 3
    for label, widths in (("pipn", FE_GLOBAL), ("pi-gano geometry", PG_GEOMETRY),
                          ("pi-gano branch", PG_BRANCH), ("pipn_pp global", PP_GLOBAL[-1]),
                          ("pi-gano-pp global", PGP_GEOMETRY[-1])):
        cols, pts, fwd_b, bwd_b = pointnet_cuda.blocks(widths)
        log(f"  blocks pointnet_global {label} {widths}: forward {pts} points, two warpgroups "
            f"of {cols} columns each, {fwd_b} bytes of shared memory; backward {bwd_b} bytes")

    # sa_neighborhood's blocks at the four levels of phase 3f
    for label, layers, k, fraction, static in (
            ("pipn_pp level 0", PP_GLOBAL[0], PP_NEIGHBORS, PP_FRACTION[:1], True),
            ("pipn_pp level 1", PP_GLOBAL[1], PP_NEIGHBORS, PP_FRACTION, False),
            ("pi-gano-pp level 0", PGP_GEOMETRY[0], PGP_NEIGHBORS, PGP_FRACTION[:1], True),
            ("pi-gano-pp level 1", PGP_GEOMETRY[1], PGP_NEIGHBORS, PGP_FRACTION, False)):
        n_pts = [N_BND]
        for f in fraction:
            n_pts.append(fps_count(n_pts[-1], f))
        blk = sa_blocks_at(layers, n_pts[-1], k, n_pts[-2], static)
        log(f"  blocks sa_neighborhood {label} {layers}, {n_pts[-1]} centroids of {k}: "
            + ", ".join(f"{key} {val}" for key, val in blk.items()))
        if min(blk["fwd_blocks_per_sm"], blk["bwd_blocks_per_sm"]) < 1:
            fail(f"sa_neighborhood {label}: a kernel fits no block on an SM ({blk})")

    gen = torch.Generator().manual_seed(SEED)
    kernels = {}

    def add_entry(key, res, **extra):
        kernels[key] = entry(key, res["err"], res["ms"], res["plain_ms"], res["flops"],
                             res["nbytes"], pk, **res.get("extra", {}), **extra)

    # ---- 3a, 3b. pointnet_global forward and backward, all three shapes -----
    clock("3a, 3b")
    n_pts = N_INT + N_BND
    pn_fwd, pn_bwd = check_pointnet(FE_GLOBAL, n_pts, True, gen, "pipn")
    pg_shapes = {"geometry_encoder": (PG_GEOMETRY, n_pts), "branch": (PG_BRANCH, PG_N_BRANCH)}
    pg_pn = {k: check_pointnet(layers, n, False, gen, f"pi-gano {k}")
             for k, (layers, n) in pg_shapes.items()}
    for i, (key, res) in enumerate((("pointnet_global", pn_fwd), ("pointnet_global_bwd",
                                                                  pn_bwd))):
        at_pg = {k: {"input": [BATCH, pg_shapes[k][1], pg_shapes[k][0][0]],
                     "widths": pg_shapes[k][0], **shape_timing(v[i], pk)}
                 for k, v in pg_pn.items()}
        extra = {"winner_rows": res["winner_rows"]} if "winner_rows" in res else {}
        kernels[key] = entry(key, max([res["err"]] + [v[i]["err"] for v in pg_pn.values()]),
                             res["ms"], res["plain_ms"], res["flops"], res["nbytes"], pk,
                             at_pi_gano_shapes=at_pg, **extra)

    # ---- 3c, 3d. decoder_prop forward and backward, dropout on and off ---------
    clock("3c, 3d")
    if decoder_cuda.philox(torch.tensor(
            [[0, 0, 0, 0, 0, 0], [0xFFFFFFFF] * 6,
             [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0]],
            dtype=torch.int64, device=dev)).cpu().tolist() != [
            [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]:
        fail("the kernels' Philox4x32-10 misses Random123's known answers")
    log("  Philox4x32-10 on the card: Random123 known answers match")
    mask = dropout.keep_mask(SEED, 0, BATCH, N_INT + N_BND, SEG[1], 0.05, dev)
    kept = float((mask > 0).float().mean())
    log(f"  kept fraction of a ({BATCH}, {N_INT + N_BND}, {SEG[1]}) mask at rate 0.05: "
        f"{kept:.6f}")
    if abs(kept - 0.95) > 0.002:
        fail(f"kept fraction {kept} not within 0.95 +- 0.002")
    del mask
    dec_fwd, dec_bwd = check_decoder(SEG, SEG_DROPOUT, gen, "pipn")
    split_backward(torch, dec_bwd, grad_shapes(*[[FE_LOCAL[-1]] + SEG[1:]] * 2), pk)
    add_entry("decoder_prop", dec_fwd)
    add_entry("decoder_prop_bwd", dec_bwd)

    # ---- 3e. neural_ops_prop forward and backward, dropout on and off ---------
    clock("3e")
    def trunk_widths(reduction=True):
        return [PG_LOCAL[-1]] + [PG_BRANCH[-1]] * PG_OPERATORS + [3] * reduction

    tr_fwd, tr_bwd = check_trunk(gen)
    split_backward(torch, tr_bwd, grad_shapes(*[trunk_widths()] * 2), pk)
    add_entry("neural_ops_prop", tr_fwd)
    add_entry("neural_ops_prop_bwd", tr_bwd)
    torch.cuda.empty_cache()

    # ---- 3j. neural_ops_prop's other modes at pi-gano-full's shapes ------------
    clock("3j")
    for key, mode in (("full", (False, False)), ("linear_last", (False, True)),
                      ("no_reduction", (True, False))):
        fwd, bwd = check_trunk(gen, *mode)
        split_backward(torch, bwd, grad_shapes(*[trunk_widths(mode[1])] * 2), pk)
        add_entry(f"neural_ops_prop_{key}", fwd, mode=trunk_mode(*mode))
        add_entry(f"neural_ops_prop_{key}_bwd", bwd, mode=trunk_mode(*mode))
        torch.cuda.empty_cache()

    data = make_foam_batch(N_CASES, N_INT, N_BND, N_OBS, seed=SEED)
    scalers = make_scalers()

    def pipn_model(device):
        return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                         seg_dropout=SEG_DROPOUT,
                         generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_coupled_model(device):
        return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                         seg_dropout=SEG_DROPOUT, coupled_context=True,
                         generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_exact_model(device):
        return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                         seg_dropout=SEG_DROPOUT, fast_derivatives=False,
                         generator=torch.Generator().manual_seed(SEED), device=device)

    def pi_gano_model(device, fast=True):
        return pi_gano(NU, 3, PG_BRANCH, PG_GEOMETRY, PG_LOCAL, PG_OPERATORS, PG_DROPOUT,
                       scalers, VARIABLE_BOUNDARIES, fast_derivatives=fast,
                       generator=torch.Generator().manual_seed(SEED), device=device)

    def pi_gano_full_model(device):
        return pi_gano(NU, 3, PG_BRANCH, PG_GEOMETRY, PG_LOCAL, PG_OPERATORS, PG_DROPOUT,
                       scalers, VARIABLE_BOUNDARIES, full=True, fast_derivatives=True,
                       generator=torch.Generator().manual_seed(SEED), device=device)

    def pi_gano_pp_model(device, fast=True):
        return pi_gano_pp(NU, 3, PG_BRANCH, PGP_GEOMETRY, PGP_RADIUS, PGP_FRACTION, PG_LOCAL,
                          PG_OPERATORS, PG_DROPOUT, scalers, VARIABLE_BOUNDARIES,
                          max_neighbors=PGP_NEIGHBORS, fast_derivatives=fast,
                          generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_pp_model(device, fast=True):
        return pipn_foam_pp(NU, D, F, PP_LOCAL, PP_GLOBAL, PP_RADIUS, PP_FRACTION, PP_SEG,
                            scalers, seg_dropout=PP_DROPOUT, max_neighbors=PP_NEIGHBORS,
                            fast_derivatives=fast, generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_pp_mrg_model(device, fast=True):
        return pipn_foam_pp_mrg(2, MRG_IN, NU, D, F, MRG_LOCAL, MRG_SEG, scalers,
                                seg_dropout=MRG_DROPOUT, max_neighbors=PP_NEIGHBORS,
                                fast_derivatives=fast,
                                generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_pp_ms_model(device):
        return pipn_manufactured_pp(0.01, 50.0, 1.0, MSP_LOCAL, MSP_GLOBAL, MSP_RADIUS,
                                    MSP_FRACTION, MSP_SEG, max_neighbors=MSP_NEIGHBORS,
                                    generator=torch.Generator().manual_seed(SEED),
                                    device=device)

    def pipn_pp_full_model(device, fast=True):
        return fixed_train.get_model(Namespace(model="pipn-pp-full"), scalers, device, fast)

    def pi_gano_pp_full_model(device, fast=True):
        return variable_train.get_model(Namespace(model="pi-gano-pp-full"), scalers, device,
                                        fast)

    # ---- 3f. sa_neighborhood at PIPN++'s level shapes, on a real chain --------
    clock("3f")
    pp_card = pipn_pp_model(dev)
    chain = pp_card.neighbor_precompute(gather_cases(data, torch.arange(BATCH)).to(dev))
    sa_fwd, sa_bwd = check_sa(pp_card.module.feature_extract.global_feature, chain, gen, pk)
    add_entry("sa_neighborhood", sa_fwd)
    add_entry("sa_neighborhood_bwd", sa_bwd)
    del pp_card, chain
    # and at PI-GANO++'s levels, 32 neighbours
    pgp_card = pi_gano_pp_model(dev)
    chain = pgp_card.neighbor_precompute(gather_cases(data, torch.arange(BATCH)).to(dev))
    pgp_sa = check_sa(pgp_card.module.geometry_encoder.set_abstraction, chain, gen, pk,
                      len(PGP_RADIUS))
    for i, k in enumerate(("sa_neighborhood", "sa_neighborhood_bwd")):
        kernels[k]["at_pi_gano_pp_shape"] = {"neighbors": PGP_NEIGHBORS,
                                             "widths": PGP_GEOMETRY[:len(PGP_RADIUS)],
                                             **shape_timing(pgp_sa[i], pk),
                                             **pgp_sa[i]["extra"]}
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], pgp_sa[i]["err"])
    del pgp_card, chain

    # ---- 3g. FPS at PIPN++'s two levels, every case ---------------------------
    clock("3g")
    n_cent = [fps_count(N_BND, PP_FRACTION[0])]
    n_cent.append(fps_count(n_cent[0], PP_FRACTION[1]))
    add_entry("farthest_point_sampling", check_fps(data, n_cent), exact="indices equal")

    # ---- 3h. pointnet_global and decoder_prop at PIPN++'s shapes, and --------
    clock("3h")
    # pointnet_global at PI-GANO++'s global level (its input needs dx too)
    pp_pn = check_pointnet(PP_GLOBAL[-1], n_cent[1], True, gen, "pipn_pp global")
    pp_dec = check_decoder(PP_SEG, PP_DROPOUT, gen, "pipn_pp")
    split_backward(torch, pp_dec[1], grad_shapes(*[[FE_LOCAL[-1]] + PP_SEG[1:]] * 2), pk)
    pgp_cent = fps_count(fps_count(N_BND, PGP_FRACTION[0]), PGP_FRACTION[1])
    pgp_pn = check_pointnet(PGP_GEOMETRY[-1], pgp_cent, True, gen, "pi-gano-pp global")
    for key, pair, at, shape in (
            ("pointnet_global", pp_pn, "at_pipn_pp_shape",
             {"input": [BATCH, n_cent[1], PP_GLOBAL[-1][0]], "widths": PP_GLOBAL[-1]}),
            ("decoder_prop", pp_dec, "at_pipn_pp_shape",
             {"widths": PP_SEG, "dropout": PP_DROPOUT}),
            ("pointnet_global", pgp_pn, "at_pi_gano_pp_global_shape",
             {"input": [BATCH, pgp_cent, PGP_GEOMETRY[-1][0]], "widths": PGP_GEOMETRY[-1]})):
        for i, k in enumerate((key, f"{key}_bwd")):
            kernels[k][at] = {**shape, **shape_timing(pair[i], pk), **pair[i].get("extra", {})}
            kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], pair[i]["err"])

    # ---- 3k. PIPN++ MRG's five kernel shapes, on a real chain ---------------------
    clock("3k")
    mrg_card = pipn_pp_mrg_model(dev)
    mrg_batch = mrg_card.attach_neighbors(gather_cases(data, torch.arange(BATCH)).to(dev))
    for key, levels in check_mrg(mrg_card, mrg_batch, gen, pk).items():
        kernels[key]["at_pipn_pp_mrg_shapes"] = levels
        kernels[key]["max_abs_err"] = max([kernels[key]["max_abs_err"]]
                                          + [v["max_abs_err"] for v in levels.values()])
    del mrg_card, mrg_batch
    torch.cuda.empty_cache()

    # ---- 3i. decoder_prop's coupled modes at the pipn shape, real winners --------
    clock("3i")
    coupled = check_decoder_coupled(pipn_coupled_model(dev),
                                    gather_cases(data, torch.arange(BATCH)).to(dev), pk)
    for mode, key in (("j0_add", "decoder_prop_j0_add"), ("ctx_width", "decoder_prop_ctx")):
        widths = [FE_LOCAL[-1]] + SEG[1:]
        split_backward(torch, coupled[mode][1],
                       grad_shapes([SEG[0] if mode == "ctx_width" else widths[0]] + widths[1:],
                                   widths), pk)
        add_entry(key, coupled[mode][0], mode=mode)
        add_entry(f"{key}_bwd", coupled[mode][1], mode=mode)
    torch.cuda.empty_cache()

    # ---- 3m. the manufactured PIPN++'s shapes at tanh, on a real chain --------------
    clock("3m")
    import numpy as np
    data_ms = make_manufactured_batch(np.random.default_rng(SEED), N_CASES, MSP_INT, MSP_BND)
    for key, numbers in check_manufactured_pp(pipn_pp_ms_model(dev), data_ms, gen, pk).items():
        kernels[key]["at_pipn_pp_manufactured_shape"] = numbers
        kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], numbers["max_abs_err"])
    torch.cuda.empty_cache()

    # ---- 3n. the U-Nets' shapes: FPS over all points, SA, global levels, branch --------
    clock("3n")
    unet_models = {"pipn-pp-full": pipn_pp_full_model(dev),
                   "pi-gano-pp-full": pi_gano_pp_full_model(dev)}
    for key, numbers in check_unet(unet_models, data, gen, pk).items():
        kernels[key]["at_unet_shapes"] = numbers
        kernels[key]["max_abs_err"] = max([kernels[key]["max_abs_err"]]
                                          + [v["max_abs_err"] for v in numbers.values()])
    del unet_models
    torch.cuda.empty_cache()

    # ---- 29. the batched 3D solver; the 3D experiments' data --------------------------
    clock("29")
    from porous_cfd_tpu_torch.data.dataset import FoamDataset
    from porous_cfd_tpu_torch.examples.abc import train as abc_train
    from porous_cfd_tpu_torch.examples.windbreaks import train as wb_train
    d3_tmp = tempfile.TemporaryDirectory()
    d3_root = {"abc": Path(d3_tmp.name) / "abc", "windbreaks": Path(d3_tmp.name) / "windbreaks"}
    solver_report = solver_phase(d3_root["abc"], name, smi)
    write_windbreaks_split(d3_root["windbreaks"])
    d3_sets = {exp: FoamDataset(str(r / "train"), N_INT, N_BND, N_OBS,
                                rng=np.random.default_rng(SEED)) for exp, r in d3_root.items()}
    d3_data = {exp: ds.stacked().to("cpu") for exp, ds in d3_sets.items()}
    d3_scalers = {exp: ds.normalizers for exp, ds in d3_sets.items()}

    def zoo_model(experiment, model_type):
        cli = abc_train if experiment == "abc" else wb_train

        def build(device, fast=True):
            return cli.get_model(Namespace(model=model_type), d3_scalers[experiment], device,
                                 fast)
        return build

    # ---- 3o. the 3D experiments' kernel shapes ----------------------------------------
    clock("3o")
    d3_models = {f"{exp} {m}": zoo_model(exp, m)(dev)
                 for exp, names in (("abc", ABC_CLI_MODELS), ("windbreaks", WB_CLI_MODELS))
                 for m in names}
    for key, numbers in check_3d_kernels(d3_models, d3_data, gen, pk).items():
        kernels[key]["at_3d_shapes"] = numbers
        kernels[key]["max_abs_err"] = max([kernels[key]["max_abs_err"]]
                                          + [v["max_abs_err"] for v in numbers.values()])
    del d3_models
    for kern in kernels.values():
        log(json.dumps({"kernel_timing": kern}))
    torch.cuda.empty_cache()

    # ---- 4, 5. pipn: verbose prediction, then training -------------------------
    clock("4, 5")
    pipn_pred = prediction_phase("pipn", pipn_model(dev), pipn_model("cpu"), data, scalers,
                                 counters, counts(pointnet_global=1, decoder_prop=2),
                                 name, smi)
    pipn_train = training_phase("pipn", pipn_model, data, counters,
                                counts(pointnet_global=1, pointnet_global_bwd=1,
                                       decoder_prop=2, decoder_prop_bwd=2),
                                name, smi, "pipn")
    torch.cuda.empty_cache()

    # ---- 6, 7. pi-gano: verbose prediction, then training -----------------------
    clock("6, 7")
    pg_pred = prediction_phase("pi-gano", pi_gano_model(dev), pi_gano_model("cpu"), data,
                               scalers, counters, counts(pointnet_global=2, neural_ops_prop=2),
                               name, smi)
    pg_train = training_phase("pi-gano", pi_gano_model, data, counters,
                              counts(pointnet_global=2, pointnet_global_bwd=2,
                                     neural_ops_prop=2, neural_ops_prop_bwd=2),
                              name, smi, "pi-gano")
    torch.cuda.empty_cache()

    # ---- 6b, 7b. pi-gano-full: verbose prediction, then training ------------------
    clock("6b, 7b")
    pgf_pred = prediction_phase("pi-gano-full", pi_gano_full_model(dev),
                                pi_gano_full_model("cpu"), data, scalers, counters,
                                counts(pointnet_global=2, neural_ops_prop=6,
                                       neural_ops_prop_full=6), name, smi)
    pgf_train = training_phase("pi-gano-full", pi_gano_full_model, data, counters,
                               counts(pointnet_global=2, pointnet_global_bwd=2,
                                      neural_ops_prop=6, neural_ops_prop_bwd=6,
                                      neural_ops_prop_full=6, neural_ops_prop_full_bwd=6),
                               name, smi, "pi-gano-full")
    torch.cuda.empty_cache()

    # ---- 6c, 7c. pi-gano-pp: the chain, verbose prediction, then training ---------
    clock("6c, 7c")
    log("pi-gano-pp boundary chain, card against CPU:")
    pgp_chain = check_chain(pi_gano_pp_model(dev), pi_gano_pp_model("cpu"), data,
                            len(PGP_RADIUS), PGP_NEIGHBORS)
    pgp_pred = prediction_phase("pi-gano-pp", pi_gano_pp_model(dev), pi_gano_pp_model("cpu"),
                                data, scalers, counters,
                                counts(sa_neighborhood=2, pointnet_global=2, neural_ops_prop=2),
                                name, smi, per_evaluate=counts(farthest_point_sampling=2),
                                share_aux=True)
    pgp_train = training_phase("pi-gano-pp", pi_gano_pp_model, data, counters,
                               counts(sa_neighborhood=2, sa_neighborhood_bwd=2,
                                      pointnet_global=2, pointnet_global_bwd=2,
                                      neural_ops_prop=2, neural_ops_prop_bwd=2),
                               name, smi, "pi-gano-pp",
                               want_attach=counts(farthest_point_sampling=2), share_aux=True)
    torch.cuda.empty_cache()

    # ---- 8, 9. pipn_pp: the chain, verbose prediction, then training ------------
    clock("8, 9")
    log("pipn_pp boundary chain, card against CPU:")
    pp_chain = check_chain(pipn_pp_model(dev), pipn_pp_model("cpu"), data)
    pp_pred = prediction_phase("pipn_pp", pipn_pp_model(dev), pipn_pp_model("cpu"), data,
                               scalers, counters,
                               counts(sa_neighborhood=2, pointnet_global=1, decoder_prop=2),
                               name, smi, per_evaluate=counts(farthest_point_sampling=2),
                               share_aux=True)
    pp_train = training_phase("pipn_pp", pipn_pp_model, data, counters,
                              counts(sa_neighborhood=2, sa_neighborhood_bwd=2,
                                     pointnet_global=1, pointnet_global_bwd=1,
                                     decoder_prop=2, decoder_prop_bwd=2),
                              name, smi, "pipn-pp",
                              want_attach=counts(farthest_point_sampling=2), share_aux=True)

    torch.cuda.empty_cache()

    # ---- 10, 11. pipn_coupled: the paths off the winners, prediction, training ---
    clock("10, 11")
    log("pipn_coupled: coupled against decoupled on the card, a batch of "
        f"{BATCH}:")
    paths_coupled = check_paths_off_winners(
        {"coupled": pipn_coupled_model(dev), "decoupled": pipn_model(dev)},
        gather_cases(data, torch.arange(BATCH)).to(dev))
    want_coupled = dict(pointnet_global=1, decoder_prop=2, decoder_prop_j0_add=1)
    pc_pred = prediction_phase("pipn_coupled", pipn_coupled_model(dev),
                               pipn_coupled_model("cpu"), data, scalers, counters,
                               counts(**want_coupled), name, smi, row_mask=agreeing_rows)
    two = first_agreeing_cases(pipn_coupled_model(dev), pipn_coupled_model("cpu"),
                               gather_cases(data, torch.arange(8)))
    pc_train = training_phase("pipn_coupled", pipn_coupled_model, data, counters,
                              counts(**want_coupled, pointnet_global_bwd=1, decoder_prop_bwd=2,
                                     decoder_prop_j0_add_bwd=1),
                              name, smi, "pipn", two_cases=two)
    torch.cuda.empty_cache()

    # ---- 12, 13. pipn_exact: no kernel ------------------------------------------
    clock("12, 13")
    log("pipn_exact: exact, coupled and decoupled on the card, 2 cases:")
    paths_exact = check_paths_off_winners(
        {"coupled": pipn_coupled_model(dev), "decoupled": pipn_model(dev),
         "exact": pipn_exact_model(dev)}, gather_cases(data, torch.tensor(two)).to(dev))
    ex_pred = prediction_phase("pipn_exact", pipn_exact_model(dev), pipn_exact_model("cpu"),
                               data, scalers, counters, counts(), name, smi, compare_cases=2)
    ex_train = training_phase("pipn_exact", pipn_exact_model, data, counters, counts(), name,
                              smi, "pipn", runs=EXACT_RUNS, epochs=EXACT_EPOCHS,
                              two_cases=two)
    torch.cuda.empty_cache()

    # ---- 14. manufactured solutions -----------------------------------------------
    clock("14")
    ms_report = manufactured_phase(counters, counts, name, smi)
    torch.cuda.empty_cache()

    # ---- 15. the duct_variable_boundary CLI, pi-gano-full ---------------------------
    clock("15")
    cli_keep = tempfile.TemporaryDirectory()
    cli_report = cli_phase(name, smi, Path(cli_keep.name))
    torch.cuda.empty_cache()

    # ---- 16, 17. pipn_pp_mrg: the chain, verbose prediction, then training ----------
    clock("16, 17")
    log("pipn_pp_mrg boundary chain, card against CPU:")
    mrg_chain = check_chain(pipn_pp_mrg_model(dev), pipn_pp_mrg_model("cpu"), data)
    want_mrg = dict(sa_neighborhood=3, pointnet_global=2, decoder_prop=2)
    mrg_pred = prediction_phase("pipn_pp_mrg", pipn_pp_mrg_model(dev), pipn_pp_mrg_model("cpu"),
                                data, scalers, counters, counts(**want_mrg), name, smi,
                                per_evaluate=counts(farthest_point_sampling=2), share_aux=True)
    mrg_train = training_phase("pipn_pp_mrg", pipn_pp_mrg_model, data, counters,
                               counts(**want_mrg, sa_neighborhood_bwd=3, pointnet_global_bwd=2,
                                      decoder_prop_bwd=2),
                               name, smi, "pipn-pp-mrg",
                               want_attach=counts(farthest_point_sampling=2), share_aux=True)
    torch.cuda.empty_cache()

    # ---- 18. the duct_fixed_boundary CLIs on golden-duct data ----------------------
    clock("18")
    fixed_keep = tempfile.TemporaryDirectory()
    fixed_report = fixed_cli_phase(name, smi, counters, Path(fixed_keep.name))
    torch.cuda.empty_cache()

    # ---- 19. the port's bench ------------------------------------------------------
    clock("19")
    bench_report = bench_phase(name, smi)
    torch.cuda.empty_cache()

    # ---- 20, 21. pipn_pp_manufactured: the chain, verbose prediction, training -------
    clock("20, 21")
    log("pipn_pp_manufactured boundary chain, card against CPU:")
    msp_chain = check_chain(pipn_pp_ms_model(dev), pipn_pp_ms_model("cpu"), data_ms,
                            len(MSP_RADIUS), MSP_NEIGHBORS)
    want_msp = dict(sa_neighborhood=2, pointnet_global=1, decoder_prop=2)
    msp_points = (MSP_INT, MSP_BND, 0)
    msp_pred = prediction_phase("pipn_pp_manufactured", pipn_pp_ms_model(dev),
                                pipn_pp_ms_model("cpu"), data_ms, {}, counters,
                                counts(**want_msp), name, smi,
                                per_evaluate=counts(farthest_point_sampling=2), share_aux=True,
                                points=msp_points)
    msp_train = training_phase("pipn_pp_manufactured", pipn_pp_ms_model, data_ms, counters,
                               counts(**want_msp, sa_neighborhood_bwd=2, pointnet_global_bwd=1,
                                      decoder_prop_bwd=2),
                               name, smi, "pipn-pp",
                               want_attach=counts(farthest_point_sampling=2), share_aux=True,
                               weights=MSP_WEIGHTS, points=msp_points)
    torch.cuda.empty_cache()

    # ---- 22. the manufactured_solutions CLIs ------------------------------------------
    clock("22")
    ms_cli_report = manufactured_cli_phase(name, smi, counters)
    torch.cuda.empty_cache()

    # ---- 23. the exact paths of PIPN++, PIPN++ MRG, PI-GANO and PI-GANO++ --------------
    clock("23")
    exact_report = exact_paths_phase({"pipn-pp": pipn_pp_model,
                                      "pipn-pp-mrg": pipn_pp_mrg_model,
                                      "pi-gano": pi_gano_model,
                                      "pi-gano-pp": pi_gano_pp_model}, data, counters, name, smi)

    torch.cuda.empty_cache()

    # ---- 24, 25. pipn_pp_full: the all-points chain, verbose prediction, training -------
    clock("24, 25")
    log("pipn_pp_full all-points chain and FP kNN indices, card against CPU:")
    upf = pipn_pp_full_model(dev)
    upf_chain = check_chain(upf, pipn_pp_full_model("cpu"), data, len(upf.module.encoder.radius),
                            upf.module.max_neighbors)
    del upf
    want_upf = dict(sa_neighborhood=2, pointnet_global=1)
    upf_pred = prediction_phase("pipn_pp_full", pipn_pp_full_model(dev),
                                pipn_pp_full_model("cpu"), data, scalers, counters,
                                counts(**want_upf), name, smi,
                                per_evaluate=counts(farthest_point_sampling=2), share_aux=True,
                                compare_cases=2, rtol={"lap": UNET_H_RTOL})
    upf_train = training_phase("pipn_pp_full", pipn_pp_full_model, data, counters,
                               counts(**want_upf, sa_neighborhood_bwd=2, pointnet_global_bwd=1),
                               name, smi, "pipn-pp-full",
                               want_attach=counts(farthest_point_sampling=2), share_aux=True,
                               pooled_rtol={"encoder.": UNET_POOLED_RTOL})
    torch.cuda.empty_cache()

    # ---- 26, 27. pi_gano_pp_full: the all-points chain, verbose prediction, training ----
    clock("26, 27")
    log("pi_gano_pp_full all-points chain and FP kNN indices, card against CPU:")
    ugf = pi_gano_pp_full_model(dev)
    ugf_chain = check_chain(ugf, pi_gano_pp_full_model("cpu"), data,
                            len(ugf.module.encoder.radius), ugf.module.max_neighbors)
    del ugf
    want_ugf = dict(sa_neighborhood=2, pointnet_global=2)
    ugf_pred = prediction_phase("pi_gano_pp_full", pi_gano_pp_full_model(dev),
                                pi_gano_pp_full_model("cpu"), data, scalers, counters,
                                counts(**want_ugf), name, smi,
                                per_evaluate=counts(farthest_point_sampling=2), share_aux=True,
                                compare_cases=2, rtol={"lap": UNET_H_RTOL})
    ugf_train = training_phase("pi_gano_pp_full", pi_gano_pp_full_model, data, counters,
                               counts(**want_ugf, sa_neighborhood_bwd=2, pointnet_global_bwd=2),
                               name, smi, "pi-gano-pp-full",
                               want_attach=counts(farthest_point_sampling=2), share_aux=True,
                               pooled_rtol={"encoder.": UNET_POOLED_RTOL})
    torch.cuda.empty_cache()

    # ---- 28. the U-Nets' exact paths: micro-batches, peak memory ------------------------
    clock("28")
    unet_exact_report = unet_exact_phase({"pipn-pp-full": pipn_pp_full_model,
                                          "pi-gano-pp-full": pi_gano_pp_full_model},
                                         data, counters, name, smi)
    torch.cuda.empty_cache()

    # ---- 30-35. the 3D experiments: abc pipn and pipn-pp on the solver's cases,
    # windbreaks pi-gano and pi-gano-pp on the synthetic split ----------------------------
    clock("30-35")
    d3 = {}
    for label, exp, model_type, want, per_attach, weights in (
            ("abc_pipn", "abc", "pipn", dict(pointnet_global=1, decoder_prop=2), {},
             ABC_WEIGHTS),
            ("abc_pipn_pp", "abc", "pipn-pp",
             dict(sa_neighborhood=2, pointnet_global=1, decoder_prop=2),
             dict(farthest_point_sampling=2), ABC_WEIGHTS),
            ("windbreaks_pi_gano", "windbreaks", "pi-gano",
             dict(pointnet_global=2, neural_ops_prop=2), {}, WB_WEIGHTS),
            ("windbreaks_pi_gano_pp", "windbreaks", "pi-gano-pp",
             dict(sa_neighborhood=2, pointnet_global=2, neural_ops_prop=2),
             dict(farthest_point_sampling=2), WB_WEIGHTS)):
        build = zoo_model(exp, model_type)
        chain = None
        if per_attach:
            log(f"{label} boundary chain, card against CPU:")
            card = build(dev)
            chain = check_chain(card, build("cpu"), d3_data[exp], 2, card.module.max_neighbors)
            del card
        pred = prediction_phase(label, build(dev), build("cpu"), d3_data[exp], d3_scalers[exp],
                                counters, counts(**want), name, smi,
                                per_evaluate=counts(**per_attach) if per_attach else None,
                                share_aux=bool(per_attach), dims=3)
        train = training_phase(label, build, d3_data[exp], counters,
                               counts(**want, **{f"{k}_bwd": v for k, v in want.items()}),
                               name, smi, model_type,
                               want_attach=counts(**per_attach) if per_attach else None,
                               share_aux=bool(per_attach), weights=weights)
        d3[label] = {"chain": chain, "slice": pred, "train": train}
        torch.cuda.empty_cache()

    # ---- 36. the 3D experiments' CLIs ------------------------------------------------------
    clock("36")
    d3_cli = {"abc": cli_3d_phase("abc", ABC_CLI_MODELS, d3_root["abc"], ABC_WEIGHTS,
                                  counters, name, smi),
              "windbreaks": cli_3d_phase("windbreaks", WB_CLI_MODELS, d3_root["windbreaks"],
                                         WB_WEIGHTS, counters, name, smi)}
    d3_tmp.cleanup()

    # ---- 37. the batched 2D solver: the JAX test's cases, one grid chunk ----------------
    clock("37")
    solver_2d_report = solver_2d_phase(name, smi)
    torch.cuda.empty_cache()

    # ---- 38. the hard and vertical CLIs on phase 18's cases and checkpoint -------------
    clock("38")
    hard_vertical_report = hard_vertical_cli_phase(fixed_keep.name, name, smi, counters)
    torch.cuda.empty_cache()

    # ---- 39. a small transform grid: generate, train, score, analyse --------------------
    clock("39")
    grid_report = grid_phase(name, smi, counters)
    torch.cuda.empty_cache()

    # ---- 40. compare on phase 18's and phase 15's checkpoints, the error table ----------
    clock("40")
    compare_report = compare_phase(fixed_keep.name, cli_keep.name, counters, name, smi)
    fixed_keep.cleanup()
    cli_keep.cleanup()
    torch.cuda.empty_cache()

    # ---- 41. two ranks on the card (data and points axes), the CLI at --mesh-data 1 --
    clock("41")
    multi_rank_report = multi_rank_phase(name, smi, counters)
    torch.cuda.empty_cache()

    # ---- 42. the measurement tools -------------------------------------------------
    clock("42")
    tools_report = tools_phase(name, smi, counters, kernels["decoder_prop"]["flop"])
    torch.cuda.empty_cache()

    # launches on each kernel's main path (per training step; FPS per
    # attach_neighbors, the only place it runs), and per path; the ctx_width
    # mode and the trunk's single modes are on no path (the coupled path
    # takes the j0_add mode, pi-gano-full both trunk modes at once), so their
    # counts are those of the path nearest them, 0
    paths = {"pipn": (pipn_pred, pipn_train), "pi_gano": (pg_pred, pg_train),
             "pi_gano_full": (pgf_pred, pgf_train), "pi_gano_pp": (pgp_pred, pgp_train),
             "pipn_pp": (pp_pred, pp_train), "pipn_coupled": (pc_pred, pc_train),
             "pipn_exact": (ex_pred, ex_train), "pipn_pp_mrg": (mrg_pred, mrg_train),
             "pipn_pp_manufactured": (msp_pred, msp_train),
             "pipn_pp_full": (upf_pred, upf_train), "pi_gano_pp_full": (ugf_pred, ugf_train),
             **{label: (v["slice"], v["train"]) for label, v in d3.items()}}
    for k, kern in kernels.items():
        main_path = ("pi_gano_full" if k.startswith("neural_ops_prop_") and
                     k != "neural_ops_prop_bwd" else
                     "pi_gano" if k.startswith("neural_ops") else
                     "pipn_pp" if k.startswith(("sa_", "farthest")) else
                     "pipn_coupled" if k.startswith(("decoder_prop_j0", "decoder_prop_ctx"))
                     else "pipn")
        kern["main_path"] = main_path
        if k.startswith(("decoder_prop_ctx", "neural_ops_prop_linear_last",
                         "neural_ops_prop_no_reduction")):
            kern["on_a_path"] = False
        tr = paths[main_path][1]
        kern["launches"] = (tr["launches_per_attach"] if k == "farthest_point_sampling"
                            else tr["launches_per_step"])[k]
        kern["launches_by_path"] = {
            p: {"train_step": tr_["launches_per_step"][k],
                "predict_batch": pr["launches_per_batch"][k],
                "attach_neighbors": tr_["launches_per_attach"][k]}
            for p, (pr, tr_) in paths.items()}
    log(json.dumps({"slice": pipn_pred}))
    log(json.dumps({"train": pipn_train}))
    log(json.dumps({"pi_gano_slice": pg_pred}))
    log(json.dumps({"pi_gano_train": pg_train}))
    log(json.dumps({"pi_gano_full_slice": pgf_pred}))
    log(json.dumps({"pi_gano_full_train": pgf_train}))
    log(json.dumps({"pi_gano_pp_chain": pgp_chain}))
    log(json.dumps({"pi_gano_pp_slice": pgp_pred}))
    log(json.dumps({"pi_gano_pp_train": pgp_train}))
    log(json.dumps({"pipn_pp_chain": pp_chain}))
    log(json.dumps({"pipn_pp_slice": pp_pred}))
    log(json.dumps({"pipn_pp_train": pp_train}))
    log(json.dumps({"pipn_coupled_paths": paths_coupled, "pipn_exact_paths": paths_exact}))
    log(json.dumps({"pipn_coupled_slice": pc_pred}))
    log(json.dumps({"pipn_coupled_train": pc_train}))
    log(json.dumps({"pipn_exact_slice": ex_pred}))
    log(json.dumps({"pipn_exact_train": ex_train}))
    log(json.dumps({"manufactured": ms_report}))
    log(json.dumps({"cli": cli_report}))
    log(json.dumps({"pipn_pp_mrg_chain": mrg_chain}))
    log(json.dumps({"pipn_pp_mrg_slice": mrg_pred}))
    log(json.dumps({"pipn_pp_mrg_train": mrg_train}))
    log(json.dumps({"fixed_cli": fixed_report}))
    log(json.dumps({"bench": bench_report}))
    log(json.dumps({"pipn_pp_manufactured_chain": msp_chain}))
    log(json.dumps({"pipn_pp_manufactured_slice": msp_pred}))
    log(json.dumps({"pipn_pp_manufactured_train": msp_train}))
    log(json.dumps({"manufactured_cli": ms_cli_report}))
    log(json.dumps({"exact_paths": exact_report}))
    log(json.dumps({"pipn_pp_full_chain": upf_chain}))
    log(json.dumps({"pipn_pp_full_slice": upf_pred}))
    log(json.dumps({"pipn_pp_full_train": upf_train}))
    log(json.dumps({"pi_gano_pp_full_chain": ugf_chain}))
    log(json.dumps({"pi_gano_pp_full_slice": ugf_pred}))
    log(json.dumps({"pi_gano_pp_full_train": ugf_train}))
    log(json.dumps({"unet_exact_paths": unet_exact_report}))
    log(json.dumps({"solver_3d": solver_report}))
    for label, v in d3.items():
        log(json.dumps({f"{label}_chain": v["chain"]}))
        log(json.dumps({f"{label}_slice": v["slice"]}))
        log(json.dumps({f"{label}_train": v["train"]}))
    log(json.dumps({"cli_3d": d3_cli}))
    log(json.dumps({"solver_2d": solver_2d_report}))
    log(json.dumps({"hard_vertical_cli": hard_vertical_report}))
    log(json.dumps({"grid": grid_report}))
    log(json.dumps({"compare": compare_report}))
    log(json.dumps({"multi_rank": multi_rank_report}))
    log(json.dumps({"tools": {k: v for k, v in tools_report.items()
                              if k in ("phase_s", "render_smoke")}}))
    clock("end")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
