"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ladder     # phases 1-3 and 35 only, no result
    python3 chip_smoke.py --h5lite     # phases 1 and 36 only, no result
    python3 chip_smoke.py --pw-force-bias   # phases 1, 2 and 37 only

Phases, one line each, in order; any failure raises, so the script exits
non-zero and prints no result line:
  1. environment: a CUDA card is required (no CPU fallback);
  2. build the CUDA kernels of pauxy_tpu_torch/csrc from this checkout, one
     nvcc per source, all at once;
  3. each kernel against its plain PyTorch version on the same card tensors,
     at the shapes the main paths and the larger lattices give it (the
     sweep kernel also at the Hubbard-Holstein anchors' (M, na, nb) =
     (1, 1, 1), (3, 1, 1), (4, 2, 2), W in {1, 37, 200}), and at
     each kernel's cap (kernel A, kernel B, Taylor, cpqr; one past the cap
     takes the plain route by shape, without a launch), the bf16 Taylor
     kernel within 1e-3 of max|out| at (M, C) in {(33, 14), (128, 32),
     (257, 14), (208, 14), (288, 14), (384, 14), (512, 14), (513, 14),
     (257, 32), (cap, 14)}, w in {1, 37, 512}, each launch on the route
     that route_bf16 names (V resident in a cluster up to the resident
     cap, streaming past it), and the streaming route forced at (33, 14)
     and (257, 14); with
     median times at the main-path shape (kernel, plain version, and the
     one PyTorch call that computes the same function where there is one;
     for the Cholesky kernel the two calls of its route past the cap; for
     the bf16 Taylor kernel at (257, 14) w=512 the resident and the
     streaming kernel, the float32 kernel, the "xla" route and the plain
     version, and both routes at (33, 14) w=40), and for cpqr, kernel A,
     the Cholesky, the sweep and the bf16 Taylor kernels the kernel's own
     device time (profiler) beside the wrapper call's;
  4. the continuous main path at full width: 4x4 Hubbard (7, 7), U=4,
     free-electron trial, complex64, 1024 walkers, dt=0.01,
     re-orthogonalisation every 10 steps, comb population control and the
     mixed energy every step, driven through AFQMC(...).run(); every weight
     and ETotal finite, and the kernels launched as often as the step
     schedule says;
  5. the continuous golden anchor: UHF trial of
     tests/data/hubbard4x4_uhf_continuous.npz, 40 walkers, 100 blocks,
     against the reference's block energies: |diff| < max(4 se, 0.05);
  6. the discrete main path at full width: the same system with the
     discrete (Hirsch) spin decomposition and the single-site sweep
     (constrained-path CPMC), through AFQMC(...).run(); every weight and
     ETotal finite, and the launches of the step schedule;
  7. the discrete golden anchor: UHF trial of
     tests/data/hubbard4x4_uhf_discrete.npz, 40 walkers, 100 blocks, the
     same criterion;
  8. the Generic (Cholesky ab-initio) main path at the bench shape
     (bench.py:301-330: nmo=128, naux=512, (16, 16), random seed-7
     Hamiltonian), RHF-identity trial, complex64, 1024 walkers, dt=0.005,
     re-orthogonalisation every 5 steps, comb population control, the mixed
     energy every step and taylor_impl="pallas", through AFQMC(...).run():
     finite output and the launches of the step schedule (the Taylor kernel
     once a step; no exchange kernel, the supermatrix exists);
  9. the same path past the supermatrix cap: nmo=228, naux=1024, (42, 42)
     (the size class of a benzene dimer in cc-pVDZ), 256 walkers, the
     energy once a block: the exchange kernel twice per energy evaluation;
 10. the Generic golden system (tests/data/generic_nmo11.npz, 40 walkers,
     complex64, taylor_impl="pallas"): first 10 blocks on the card with
     injected draws against the port's complex128 run of the same draws on
     the host, block by block within 2e-4 (float32 rounding); then, as a
     sanity check, the golden anchor over 100 blocks, |diff| <
     max(4 se, 0.02) over the last two thirds. This anchor's block series
     are strongly autocorrelated (the JAX package misses its naive se at
     two of three seeds), so se combines the spread of 8 independent runs'
     means with the reference series' reblocked se.
 11. the finite-temperature UEG path at the bench shape (bench.py:692-716:
     make_ueg(7, 7, rs=1, ecut=4), M=93, 1500 fields; the one-body trial at
     beta=2, dt=0.05, mu=0.9, 40 slices in 4 bins of 10), complex64, 256
     walkers, population control every slice, through
     ThermalAFQMC(...).run(): every row finite, Nav > 0, the cpqr kernel
     and kernel B launched as often as the slice schedule says, and
     walker-slice-steps/s over the paths after a warm-up path; then one
     path of 16 walkers at M=93 with injected draws, complex64 on the card
     against complex128 on the host (ETotal and Nav within float32
     rounding);
 12. the finite-temperature Hubbard path: 3x3, U=4, mu=0.9, beta=0.5,
     dt=0.05, 32 walkers, population control every 2 slices, complex64:
     paths with injected draws on the card against the host's complex128
     run, then the golden anchor tests/data/thermal_hubbard3x3.npz over 60
     paths, |dE| < max(4 se, 0.05) and |dNav| < max(4 se, 0.02);
 13. discrete back propagation and ITCF at full width: phase 6's system
     and 1024 walkers (the sweep kernel's route), BP tau_bp=0.4 with
     energies and the stable ITCF with tau_max=0.4 sharing the 40-step
     field buffer, 8 blocks of 10 steps through AFQMC(...).run(): every
     row and BP / ITCF value finite, Tr of the weighted BP G = n per spin
     and G>(0) + G<(0) = I within 1e-4, and the sweep, Cholesky (forward
     CholeskyQR2 and the one-pass backward and ITCF re-orthogonalisations)
     and kernel B launches of the schedule (``discrete_schedule``); then
     16 walkers, 2 blocks with injected draws (tau_bp = tau_max = 0.1, so
     that the blocks hold measurements), complex64 on the card against
     complex128 on the host, the mixed, BP and ITCF sums each within 1e-4
     of their scale;
 14. the 3x3 tutorial anchors (tests/test_tutorial_anchors.py:27-42: U=4,
     (3,3), twist [0.01, -0.02], discrete CPMC on the scan sweep, dt=0.05,
     100 walkers, 300 blocks, tau_bp=2.0, ITCF tau_max=2.0) in complex64 on
     the card: the mixed energy, the BP energy and the ITCF G>up00(0)
     within 4 combined sigma of the published -9.667367 +/- 0.006009,
     -10.172595 +/- 0.221067 and 0.662088 +/- 0.043912, G>up00(0.9)
     within 0.05 of 0.14, and the launches of the schedule;
 15. the other run modes at full width (phase 4's system, 1024 walkers, 3
     blocks each): continuous and discrete free projection (|phase| = 1
     within 1e-5), the direct (whole-lattice) update and the k-space
     kinetic step, finite rows and their launches; continuous Hubbard
     with back propagation through the [w, M, n] block (kernel B and
     Cholesky launches of the schedule); then each mode, the local-energy
     update and continuous BP with phase restoration on 16 walkers, 2
     blocks with injected draws, card (complex64) against host
     (complex128) within 1e-4 of the scale;
 16. Generic back propagation: the golden system (generic_nmo11.npz, 16
     walkers, 3 blocks, tau_bp=0.05 with energies and EKT,
     taylor_impl="pallas") card against host within 1e-4 of the scale,
     the Taylor kernel launched in the back propagation; then phase 8's
     bench shape with one BP measurement of tau_bp=0.05: the Taylor
     kernel 10 times forward and 10 back, Tr G_bp = N per spin within
     1e-4, a finite BP energy (its dense-G exchange in chunks);
 17. the low-rank thermal UEG at phase 11's bench shape
     (walker_options low_rank, thresh 1e-6), 256 walkers, 2 paths through
     ThermalAFQMC(...).run(): finite rows, Nav > 0, the cpqr and kernel B
     launches of ``low_rank_launches``, walker-slice-steps/s beside phase
     11's; a 16-walker path card (complex64) vs host (complex128) within
     1e-4; the anchor tests/data/thermal_ueg_lowrank.npz (M=93, 16
     walkers, 160 paths, complex64): row 0 within 1e-5 of the pinned
     values, the block means of E and Nav within 4 combined se, no floor;
 18. the discrete thermal Hubbard (examples/ftafqmc_discrete: 3x3, U=4,
     mu=0.9, beta=2, 128 walkers, population control every 2 slices):
     finite rows and ``discrete_thermal_launches``; card vs host, 16
     walkers, 2 paths with injected uniforms (constrained path) and
     fields (free projection), 1e-4 of the scale; wrap_stabilize=1e9 vs 1
     slice by slice in complex128 (1e-8); U=0 exact on every row at
     beta=2 (complex64) and beta=16 (complex128); the 2-site U=4 open
     chain against grand-canonical ED (256 walkers, 48 paths,
     |dE| < max(4 se, 0.05), |dN| < 0.05);
 19. the Generic thermal inner at phase 8's bench shape (64 walkers,
     beta=0.5, one path): finite rows and the launches; the
     generic_nmo11.npz Hamiltonian, 16 walkers, one path card vs host
     within 1e-4;
 20. the thermal Hartree-Fock trial (examples/ftafqmc_thf: 3x3, U=4,
     beta=1, nav=6, system mu 0.9, 128 walkers; the trial's Nav within
     1e-3 of 6) and card vs host at 16 walkers; average_gf on phase 12's
     system in 5 bins (the launches of G at every origin counted) card vs
     host; low-rank with average_gf refused;
 21. the UEG at the bench shape (bench.py:492-520: make_ueg(7, 7, rs=1,
     ecut=8), M=257, 2108 q vectors, 4216 fields), RHF-identity trial,
     complex64, 512 walkers, dt=0.005, re-orthogonalisation every 5 steps,
     population control every step, the energy every 10 steps, one
     warm-up block and 3 timed, through AFQMC(...).run() with
     PAUXY_TPU_TAYLOR_UEG "pallas" and then "pallas_bf16": finite rows,
     the launches of the step schedule (the float32 or the bf16 Taylor
     kernel once a step, the bf16 one on its resident route),
     walker-steps/s of each tier; then 16 walkers, 2
     blocks with injected draws, card (complex64, pallas) vs host
     (complex128, xla) within 1e-4 of the scale;
 22. the UEG golden anchor tests/data/ueg_rs2.44_ecut2.npz (M=33, 40
     walkers, 100 blocks, the energy every step) in complex64 in each
     tier, |d| < max(4 se, 0.05) over the last two thirds
     (tests/test_afqmc_driver.py:180-212): the float32 tier must hold it,
     the bf16 tier's reading is reported as it falls (its end-to-end
     validation); then back propagation with two_rdm="structure_factor"
     on the golden system, 16 walkers, card vs host within 1e-4, and the
     S(k) tail against the BP two-body energy;
 23. PW_FFT: make_pw_fft(7, 7, rs=1, ecut=8) (M=257), free-electron
     trial, complex64, 512 walkers, one block: finite rows and the
     launches; 16 walkers card vs host within 1e-4;
 24. the mixed estimator's density matrices: phase 4's system with
     one_rdm (1024 walkers, 2 blocks, the generic block): each block's
     Tr G_s within 1e-4 of 7 and E1B from the 1-RDM within 1e-3 of the
     E1Body column (tests/test_mixed_rdm.py:26-52), and the launches; the
     UEG golden's shape (M=33, 40 walkers, 3 blocks) with
     two_rdm="structure_factor": S(k) . v_q / 2V within 1e-4 of E2Body;
     card (complex64) vs host (complex128), 16 walkers, 2 blocks with
     injected draws, within 1e-4 of the scale (the UEG's hybrid-energy sum
     aside);
 25. NOMSD at full width: phase 8's Generic bench shape with a D = 8
     expansion (the RHF identity and 7 rotations exp(0.1 K),
     ``rotated_msd_psi``), 1024 walkers, a warm-up block and 2 of 10 steps
     (depth cut), taylor_impl="pallas": finite rows, the launches of
     ``msd_schedule``, walker-steps/s beside phase 8's; 16 walkers card vs
     host within 2e-4 (phase 10's limit); on phase 4's Hubbard a D = 2
     expansion (the continuous golden's UHF determinant and its spin flip)
     one block with its launches, and D = 1 against the single-determinant
     block with the same draws (1e-4 of the scale);
 26. the PHMSD zero-variance anchor: generate_hamiltonian(6, (2, 2)), the
     full space of 225 determinants with recompute_ci_coeffs, 256
     walkers, 3 blocks, complex128 and complex64 on the card: every
     walker's energy at each block's end and every block's ETotal equal
     E_FCI (ci.simple_fci) within 1e-8 (complex128) and 1e-4 (complex64)
     relative; walkers exactly on a determinant (224 exactly singular
     S_d): finite G, weights, overlap and energy, the overlap conj(c_0);
 27. GHF at full width: phase 6's system with a D = 2 GHF trial (the
     discrete golden's UHF determinant embedded and its spin flip), 1024
     walkers, a warm-up block and one timed: finite rows, the launches of
     ``ghf_schedule``, walker-steps/s; the D = 1 embedding against the UHF
     run (sweep kernel) with the same uniforms, block ETotal within rtol
     5e-4 (tests/test_ghf.py:207-231); the discrete golden through the
     D = 1 GHF trial (40 walkers, 100 blocks), |diff| < max(4 se, 0.05);
     16 walkers card vs host within 1e-4;
 28. Hubbard-Holstein at full width: 4x4 periodic (7, 7), U=4, w0=1,
     lambda=0.25 (g = 1), complex64, 1024 walkers, dt=0.005,
     re-orthogonalisation and population control every 5 steps, the
     energy every 2 steps, a warm-up block and a timed one of 10 steps:
     the coherent-state trial (the sweep kernel's route) and the
     translation-symmetrised multi-coherent trial (P = 16, the Python site
     loop), finite rows, the launches of ``hh_schedule``, walker-steps/s;
     a Lang-Firsov block (U_eff tables); 16 walkers, 2 blocks with
     injected draws and phonon start (coherent, multi-coherent,
     symmetric_trotter), card (complex64) vs host (complex128) within
     1e-4 of the scale;
 29. the Hubbard-Holstein anchors of tests/test_hubbard_holstein.py in
     complex64 on the card: the single-site polaron E = U - 4 g^2 / w0
     within 0.05 (plain and symmetric_trotter), the 3-site multi-coherent
     polaron within 0.2 of ci.simple_fci_bose_fermi, g = 0 on the 4-site
     chain within 0.3 of the Hubbard FCI, a finite Lang-Firsov run with
     positive weights;
 30. the Generic energy variants at phase 8's bench shape, 1024 walkers,
     a warm-up block and a timed one: exact ERIs, PNO (thresh 1e-13),
     stochastic RI (20 probes, with and without the control variate), the
     sketched one-body step (S = 2048) and taylor_impl="xla_3m": finite
     rows, phase 8's launch schedule (no Taylor kernel with xla_3m),
     walker-steps/s; on one population the exact-ERI and PNO energies
     within 1e-4 relative of the fast path's, stochastic RI's mean over 64
     probe sets within 4 se of the exact mean; the golden Generic system,
     16 walkers, 2 blocks with injected draws (fields, sketches, probes),
     card vs host within 1e-4 of the scale for each;
 31. the file path at full width: phase 8's bench shape written with the
     port's write_hamiltonian / write_wavefunction into a temporary
     directory (HDF5 through h5py where it imports, else the port's
     h5lite) and driven from a JSON input through
     qmc.calc.setup_calculation on the card: the loaded H1, chol, ecore
     and trial orbitals equal to the written arrays cast to the run's
     dtype, a warm-up block and timed blocks (walker-steps/s beside phase
     8's), phase 8's launches, the set-up's seconds; the restart (2 blocks,
     a checkpoint, a new driver from it and 1 block, through the JSON's
     walkers section) against 3 blocks straight within 1e-6 relative a
     column; the golden system written to files, 2 blocks with injected
     draws, card vs host within 2e-4 of the scale;
 32. the molecular anchors from files: H10/STO-6G at R = 1.6 a0 through
     sgto.dump_afqmc (E_UHF within 1e-5 of -5.2562816; 100 walkers, dt
     0.005, 1000 blocks, energy every 10 steps: E within 4 combined sigma
     of -5.38331344 +/- 0.0014386 with 20 blocks skipped and 40-block
     reblocking; get_energy() equal to reblock_summary of the rows; the
     Generic launch schedule); the H2 MO golden of
     tests/data/h2_mo_r1.4.npz from files (200 walkers, dt 0.01, 300
     blocks, within 4 combined sigma, 10-block reblocking); python -m
     pauxy_tpu_torch on the H10 input cut to 8 blocks in a process of its
     own: exit 0 and the reblocked table;
 33. FCIDUMP and k-points: H10's MO integrals as FCIDUMP files, real and
     complex; the port's native parser, built with g++ from its own
     fcidump.cpp, used (no fallback, no warning) and equal to the Python
     oracle bit for bit; fcidump_to_system and bin/fcidump-to-afqmc-torch
     give RHF energies within 1e-8 relative of the sgto path's (complex128
     on the card); a k-point file round-trips exactly;
 34. the walker mesh (parallel/mesh.py) on the card: a one-rank NCCL
     process group; phase 4's continuous lanes block (1024 walkers) and
     phase 8's Generic block at the bench shape, each 2 blocks of 10
     steps, unsharded and then through walker_mesh / shard_walkers (and
     shard_generic): rows within 1e-6 relative of the unsharded run's and
     the same launches (``launches_by_path`` "mesh_continuous",
     "mesh_generic"); a sharded checkpoint round trip on the card; a
     profile_dir trace written and not empty; block_mode="split": JAX's
     table lines, phase times summing to within 10% of the blocks' wall
     time; then two ranks on the one card over gloo
     (parallel.launch.run_ranks, one process each, 512 walkers a rank),
     their rows against the one-rank run within 1e-5 relative, or, where
     gloo refuses a collective on CUDA tensors, the line says that the
     two-rank run is held by the CPU tests only; then the chol axis: two
     gloo ranks on cuda:0 as a [walker 1, chol 2] mesh (NCCL puts one
     rank on a card), each rank on every walker and half of X, against
     the same runs unsharded (``chol_driver``): (a) phase 16's bench-shape
     run with one BP measurement with energies and EKT, (b) the ITCF on
     the golden system, (c) phase 30's stochastic-RI energy (S = 20) and
     sketched step (S = 2048), (d) phase 19's thermal Generic path; rows
     and the BP / ITCF arrays within 1e-5 relative (``chol_rel``), the
     two ranks' rows equal, each rank's launches of the Cholesky, Taylor,
     kernel B and cpqr kernels equal to the unsharded run's, and the
     exchange kernel launched in (a)'s mixed energy, where the unsharded
     run takes the supermatrix (``launches_by_path`` "mesh_chol_*", rank
     0's);
 35. the matmul-precision ladder (the drivers' matmul_precision, set by
     pauxy_tpu_torch/config.py: "float32" torch's "highest"; "bfloat16_3x"
     "highest" with the split route, every float32 / complex64 aten mm /
     bmm / addmm / baddbmm on the card through the 3-pass bf16 split GEMM
     csrc/gemm_bf16x3.cu; "bfloat16" "medium", cuBLAS's TF32): (a) per tier
     the relative error of a real float32 and a complex64 product at the
     Generic VHS shape [1024, 512] x [512, 16384] against float64, with the
     torch setting in force, "bfloat16_3x" within 3e-5; (a') the split GEMM
     against its plain version (ops/gemm3) at (m, k, n) in {(7, 16, 7),
     (93, 93, 93), (257, 14, 257), (1, 33, 1), (5, 0, 3), the VHS shape},
     a batch against a broadcast operand, a batch of 70000, transposed,
     conjugated, permuted and unaligned operands, the skinny route's
     batched dot products, permuted vector-matrix products and a small N,
     addmm and baddbmm with alpha and beta; the wgmma tiles' ragged edges
     ((1000, 300, 16383), (129, 17, 130)), the narrow tile ((200, 64, 14),
     (300, 64, 30), the "xla" Taylor product [512, 257, 257] x
     [512, 257, 14]), one product staged by TMA and by row copies (rows of
     97), a broadcast A with B conjugated, baddbmm on the tile route, and
     float32 .real / .imag planes of complex tensors as A and as B (the VHS
     shape and small); float32 and complex64, within gemm3_tolerance
     (12 k eps S), each case on the route ``plan`` picks for it and every
     route taken (``launches_by_route``); and its times beside cuBLAS's
     float32 and TF32 products and its bound at the VHS shape (real,
     complex64 and A a complex tensor's real plane), the Taylor product
     and a lattice shape; (b) every kernel on its phase-3 inputs, and the
     plain routes pinned to IEEE float32 (the plain cpqr past max_m and
     unpivoted, the Taylor kernels' series past their caps), byte for byte
     equal under every tier, beside the "xla" series as a control that
     differs under each lower tier and between them; (c) each tier on the
     card (complex64) against the host's complex128 with the same injected
     draws, population control off: phase 4's continuous Hubbard cell,
     phase 10's Generic golden system and phase 22's UEG golden shape (both
     on the "xla" series), phase 12's thermal 3x3 Hubbard, within
     LADDER_BOUNDS; (d) phase 26's PHMSD zero-variance anchor in complex64
     per tier within LADDER_BOUNDS; the split GEMM launched on each path
     under "bfloat16_3x" and under no other tier, and no cuBLAS float32 /
     complex64 GEMM in the profiled "bfloat16_3x" runs; (e) the process
     back at "highest" without the route;
 36. HDF5 without h5py (``utils/h5lite``, which ``open_file`` falls back to
     where h5py does not import; h5py is hidden here if it does): the
     out-of-core Cholesky (``from_pyscf.chunked_cholesky_outcore``) of a
     synthetic rank-384 (pq|rs) at nao = 128, cmax = 10 (a [1280, 16384]
     float64 dataset, 168 MB) in chunks of 64 rows, equal to the in-core
     ``chunked_cholesky`` within 1e-12, its ``tracemalloc`` peak below
     four chunks plus eight nao^2 vectors and at least 8 times below the
     dataset; and ``tests/data/h5lite_latest_gzip.h5`` (written by h5py
     with ``libver="latest"``: a deflated, shuffled dataset indexed by an
     extensible array, a group of 12 links in dense storage) read equal to
     the values it was written with;
 37. the plane-wave force-bias kernel (``ops/pw_force_bias_cuda``,
     ``csrc/pw_force_bias.cu``) against its plain version on the same card
     tensors, in complex64 and complex128, within 1e-4 / 1e-10 of max|out|
     (the order of the sums: direct DFTs against torch.fft), with a dense
     random trial: at the UEG cells' cube (17^3, M = 257, n = 7 + 7) with
     1024, 1536 and 37 walkers, at n = 1 + 0 and 3 + 5, and at the largest
     cube the kernel takes (25^3 complex64, 21^3 complex128); a cube past
     it (25^3 complex128) takes the plain version (torch.fft) in
     PlaneWave.force_bias without a launch, equal to it within 1e-12, with
     a device-memory peak no higher than the per-spin torch.fft chains'
     (64 walkers); and the kernel's time (wrapper and device), its plain
     version's and the torch.fft route's at the cells' shape, 1024 and
     1536 walkers, beside its bound (the kernels line's row). Every path's
     launch count holds the kernel too: one a step wherever a UEG block
     runs (phases 21 and 22, phase 24's S(k), phase 35's UEG block), none
     elsewhere.
Phase 3 also holds the cpqr kernel on the low-rank stack's masked input
(``check_cpqr_masked``) and kernels A and B on exactly singular matrices
(``check_zero_pivot``: log|det| -inf, JAX's phase where JAX's is finite).
Each phase line ends with its seconds. Then the
card's name and power limit (nvidia-smi), one JSON line about the
kernels, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10, torch.float32: 1e-4,
       torch.float64: 1e-10}
# One H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and the fastest FLOP/s
# of each element type at its own precision: float32 outside the tensor
# cores, float64 on the FP64 tensor cores (DMMA; 34e12 outside them), bf16
# multiplicands with float32 sums on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.complex64: 67e12,
              torch.float64: 67e12, torch.complex128: 67e12,
              torch.bfloat16: 989e12}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fns: dict, reps: int = 25) -> dict:
    """Median CUDA-event time of each callable, measured in turns
    (a, b, ..., b, a) after a warm-up."""
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for name in order:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in samples.items()}


def device_ms(fn, key: str, reps: int = 20, tries: int = 3) -> float:
    """Device time of one launch of the kernel whose name holds ``key``
    (the profiler's kernel times over ``reps`` calls of ``fn``, one launch
    each, after a warm-up), so the host's share of a wrapper call is told
    apart from the kernel's. The profiler may drop an event at a window's
    edge, so the mean is over the events it kept (at least half). It has
    been seen to keep none of a window's device events: after ``tries``
    such windows the time is ``queued_ms``'s instead (said on stderr)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and key in e.name]
        if len(times) > reps:
            raise AssertionError(f"device_ms: {len(times)} '{key}' kernels "
                                 f"in {reps} calls")
        if len(times) >= reps // 2:
            return sum(times) / 1e3 / len(times)
    ms = queued_ms(fn, reps)
    print(f"device_ms: the profiler kept under {reps // 2} of {reps} '{key}' "
          f"kernels in {tries} windows; CUDA events over queued launches: "
          f"{ms:.5f} ms", file=sys.stderr)
    return ms


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` from CUDA events around ``reps``
    calls that were all queued behind a sleeping kernel before the first
    of them ran, so the card runs them back to back and no host time lies
    between the events. ``fn`` must not synchronize. Every kernel that a
    call launches is counted (the wrappers timed here launch one)."""
    cycles = 1 << 24
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()   # the sleep outlasted the queueing
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("queued_ms: the host never queued the calls "
                         "within the sleep")


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over the HBM rate and
    operations over the peak rate of the element type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gj_flops(n: int, ncol: int, cplx: bool) -> int:
    """Gauss-Jordan on n x ncol: elimination multiply-adds and row scaling."""
    mac, mul = (8, 6) if cplx else (2, 1)
    return sum((n - 1) * (ncol - k) * mac + (ncol - k) * mul
               for k in range(n))


C8, F4 = 8, 4   # bytes of a complex64 and of a float32


def greens_work(m: int, n: int, w: int):
    """(bytes read once + written once, FLOPs, element type) of kernel A:
    S = phi^T psi*, its inverse and log-det, ghT."""
    return ((m * n + 2 * m * n * w + w) * C8,
            w * (8 * m * n * n + gj_flops(n, 2 * n, True) + 8 * m * n * n),
            torch.complex64)


def batchla_work(n: int, w: int, want_inv: bool, dtype=torch.complex64):
    """Kernel B: S in, the log-det (and the inverse) out; what the function
    needs, not what a design does: ~n^3 multiply-adds for the inverse, ~n^3
    / 3 for the log-det (LU), 8 FLOPs each in complex and 2 in real."""
    esize = dtype.itemsize
    cplx_size = 2 * esize if not dtype.is_complex else esize
    mac = 8 if dtype.is_complex else 2
    return ((n * n * w * (2 if want_inv else 1)) * esize + w * cplx_size,
            w * mac * (n ** 3 if want_inv else n ** 3 / 3), dtype)


def chol_work(n: int, w: int):
    """The Cholesky kernel reads the lower triangle and writes L^-1 dense
    and log det L."""
    return ((n * (n + 1) // 2 + n * n) * w * C8 + w * F4,
            w * sum(8 * (n - k - 1) * (n - k) // 2 + 2 * (n - k - 1)
                    + 8 * k * (k + 1) // 2 for k in range(n)),
            torch.complex64)


def sweep_work(m: int, na: int, nb: int, w: int):
    return ((m * (na + nb) + 6 + 2 * m * (na + nb) * w
             + (na * na + nb * nb) * w + m * w + 3 * w) * F4 + m * w * 4,
            w * m * sum(9 * k * k + 6 * k + 10 for k in (na, nb)),
            torch.float32)


def taylor_work(m: int, c: int, w: int):
    """VHS and phi read once, the result written once; 6 orders of a
    complex [M, M] x [M, C] product (8 FLOPs a multiply-add)."""
    return ((w * m * m + 2 * w * m * c) * C8, 6 * 8 * m * m * c * w,
            torch.complex64)


def taylor_bf16_work(m: int, c: int, w: int):
    """The bf16 tier: V's float32 planes and phi read once, the result
    written once; the same 6 orders of four real [M, M] x [M, C] products
    (2 FLOPs a multiply-add), on the bf16 tensor cores."""
    return ((w * m * m + 2 * w * m * c) * C8, 6 * 8 * m * m * c * w,
            torch.bfloat16)


def exx_work(x: int, n: int, m: int, w: int):
    """rchol (real) and Ghalf read once, exx written once; the T builds
    (real x complex: 4 FLOPs a multiply-add) and the products."""
    return (x * n * m * F4 + w * n * m * C8 + w * C8,
            w * x * (4 * n * n * m + 8 * n * n), torch.complex64)


def cpqr_work(m: int, b: int, dtype=torch.complex64, live: int | None = None):
    """The pivoted QR: a read once, q and r written once (and perm); per
    matrix the factor pass's trailing dot products and updates (8 FLOPs a
    complex multiply-add), the norms downdated by |r_kj|^2 (4 a column, as
    LAPACK and the plain version do; the kernel's exact recompute is its
    own choice, not the function's work), the Householder vectors, and the
    form-Q pass's reflector applications that touch each column
    (16 (m - k) for reflector k <= column j). With ``live`` (rank-deficient
    input whose trailing columns are exactly zero) only the first ``live``
    reflectors do work: the others have tau = 0."""
    c = 16 if dtype == torch.complex128 else C8
    live = m if live is None else live
    flops = 0
    for k in range(live):
        t = m - k
        flops += 16 * t * (t - 1) + 4 * (t - 1) + 4 * t + 6 * (t - 1)
    flops += sum(16 * (m - k) for j in range(m)
                 for k in range(min(j + 1, live)))
    return (3 * b * m * m * c + b * m * 8, b * flops, dtype)


CPQR_EPS = {torch.complex64: 2.0 ** -24, torch.float32: 2.0 ** -24,
            torch.complex128: 2.0 ** -53, torch.float64: 2.0 ** -53}


def cpqr_identities(a, q, r, perm):
    """(max reconstruction ||A[:, perm] - QR||_F / ||A||_F, max |Q^H Q - I|,
    max |below R's diagonal|, worst rise of |r_kk| over |r_00|)."""
    b, m, _ = a.shape
    ap = torch.gather(a, 2, perm[:, None, :].expand(b, m, m))
    rec = (torch.linalg.matrix_norm(ap - q @ r)
           / torch.linalg.matrix_norm(a)).max().item()
    eye = torch.eye(m, dtype=q.dtype, device=q.device)
    orth = (q.conj().transpose(1, 2) @ q - eye).abs().max().item()
    low = torch.tril(r, -1).abs().max().item()
    d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    rise = ((d[:, 1:] - d[:, :-1]).clamp_min(0).amax(-1)
            / d[:, 0].clamp_min(1e-300)).max().item()
    return rec, orth, low, rise


def separated_norms(rng, b, m, cplx):
    """(W D)[:, shuffle]: W = I + 0.05 N / sqrt(m) (cond(W) ~ 1.1), D a
    geometric column scaling from 1 down to 1e-4, the columns then
    shuffled. Consecutive scales differ by 1e4^(1/(m-1)) (10% at m = 93),
    far more than W moves a column's residual norm (~0.3%), so the pivots
    are unambiguous; and the k-th pivot column's dominant entry sits in
    row k, so its x_k is not small against ||x||: the LAPACK phase choice
    beta = -(x_k/|x_k|) ||x|| makes Q as sensitive as x_k's phase, and
    only then are Q and R well determined in float32 (~1e-6 from float64
    up to m = 162, tools/thermal_precision.py)."""
    w = np.eye(m) + 0.05 / np.sqrt(m) * rng.normal(size=(b, m, m))
    if cplx:
        w = w + 0.05j / np.sqrt(m) * rng.normal(size=(b, m, m))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return (w * scale[None, None, :])[:, :, rng.permutation(m)]


def gaussian_separated(rng, b, m, cplx):
    """(G D)[:, shuffle]: G Gaussian, D the geometric column scaling of
    separated_norms. A pivot column's k-th entry is as small against its
    norm as a Gaussian entry happens to be, so the phase that the LAPACK
    choice gives q_k and row k of R is ill-determined in float32 on a few
    columns: the plain version in float32 misses float64 there by up to
    1.021e-3 in Q (B=128, m=162, tools/thermal_precision.py), a quarter of
    what a planted phase error of 2^-8 reads. R, weighted by |r_kk|, and Q
    with each column's phase aligned to float64 stay within 6.5e-6."""
    g = rng.normal(size=(b, m, m))
    if cplx:
        g = g + 1j * rng.normal(size=(b, m, m))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return (g * scale[None, None, :])[:, :, rng.permutation(m)]


def against_double(q64, r64, q, r):
    """Float32 factors q, r against the double-precision ones q64, r64 of
    the same (float32) input with the same pivots: (max |R - R64| over each
    matrix's max |R64|, max |Q D - Q64| with D the column phases that align
    Q to Q64, max |Q - Q64|)."""
    q, r = q.to(q64.dtype), r.to(r64.dtype)
    rmax = r64.abs().amax((-2, -1), keepdim=True)
    d_r = ((r - r64).abs() / rmax).max().item()
    d = (q64.conj() * q).sum(-2)
    d = d / d.abs()
    d_qa = (q * d.conj()[:, None, :] - q64).abs().max().item()
    return d_r, d_qa, (q - q64).abs().max().item()


def check_cpqr(cpqr_cuda, rng) -> tuple[float, str]:
    """The pivoted QR kernel against its plain version at m in {9, 16, 36,
    48, 93, cap} x B in {1, 37, 512}, complex64 and complex128, and real
    float32 at (512, 93): on Gaussian input (one zero column) the
    identities within 10 m eps, exact zeros below R's diagonal, |r_kk|
    non-increasing within 10 m eps of |r_00|, the same bits on a second
    launch; on separated-norm input the plain version's pivots and Q
    within tol, R within tol max|R|; in complex64 and float32 on Gaussian
    separated-norm input, the factors against the plain version in double
    precision with the kernel's pivots: R within 1e-4 of each matrix's
    max|R| and Q, its column phases aligned, within 1e-4, a limit above the
    plain float32 version's own reading and below that of the kernel's
    factors with a planted phase error of 2^-8 on every column; a rank-7
    input finite with a vanishing trailing diagonal. Returns (largest
    |R - R_plain| at (512, 93) complex64 on separated norms, the largest
    readings)."""
    main_err, worst, routes = None, {}, set()
    wide = {"kernel": [0.0] * 3, "plain": [0.0] * 3, "planted": np.inf}
    cases = [(dt, m, b) for dt in (torch.complex64, torch.complex128)
             for m in (9, 16, 36, 48, 93, cpqr_cuda.max_m(dt))
             for b in (1, 37, 512)] + [(torch.float32, 93, 512)]
    for dtype, m, b in cases:
        tol, allow = TOL[dtype], 10 * m * CPQR_EPS[dtype]
        cplx = dtype.is_complex
        a = rng.normal(size=(b, m, m))
        if cplx:
            a = a + 1j * rng.normal(size=(b, m, m))
        a[0, :, m // 2] = 0.0
        a = torch.from_numpy(a).to("cuda", dtype)
        before = cpqr_cuda.launches
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        q2, r2, p2 = cpqr_cuda.cpqr_lanes(a)
        torch.cuda.synchronize()
        where = f"{dtype} m={m} B={b}"
        if cpqr_cuda.launches - before != 2:
            raise AssertionError(f"cpqr launches at {where}")
        routes.add(cpqr_cuda.route(m))
        if not (torch.equal(q, q2) and torch.equal(r, r2)
                and torch.equal(p, p2)):
            raise AssertionError(f"cpqr not reproducible at {where}")
        rec, orth, low, rise = cpqr_identities(a, q, r, p)
        if not (rec <= allow and orth <= allow and low == 0.0
                and rise <= allow):
            raise AssertionError(f"cpqr identities at {where}: rec {rec:.3e} "
                                 f"orth {orth:.3e} below-diagonal {low} "
                                 f"rise {rise:.3e} (allowance {allow:.3e})")
        sep = torch.from_numpy(separated_norms(rng, b, m, cplx)).to(
            "cuda", dtype)
        qk, rk, pk = cpqr_cuda.cpqr_lanes(sep)
        qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(sep)
        torch.cuda.synchronize()
        dq = (qk - qp).abs().max().item()
        dr = (rk - rp).abs().max().item()
        rmax = rp.abs().max().item()
        if not (torch.equal(pk, pp) and dq <= tol and dr <= tol * rmax):
            raise AssertionError(f"cpqr disagrees with its plain version at "
                                 f"{where}: same pivots "
                                 f"{bool(torch.equal(pk, pp))}, dQ {dq:.3e}, "
                                 f"dR/max {dr / rmax:.3e} (tol {tol})")
        if dtype in (torch.complex64, torch.float32):
            g = torch.from_numpy(gaussian_separated(rng, b, m, cplx)).to(
                "cuda", dtype)
            qk, rk, pk = cpqr_cuda.cpqr_lanes(g)
            gp = torch.gather(g, 2, pk[:, None, :].expand(b, m, m))
            qp, rp, _ = cpqr_cuda.cpqr_lanes_plain(gp, pivot=False)
            q64, r64, _ = cpqr_cuda.cpqr_lanes_plain(
                gp.to(torch.complex128 if cplx else torch.float64),
                pivot=False)
            kern = against_double(q64, r64, qk, rk)
            plain = against_double(q64, r64, qp, rp)
            planted = np.inf
            if cplx:
                turn = complex(np.exp(1j * 2.0 ** -8))
                planted = against_double(q64, r64, qk * turn, rk / turn)[0]
            del q64, r64
            if not (kern[0] <= tol and kern[1] <= tol and plain[0] <= tol
                    and plain[1] <= tol and planted > tol):
                raise AssertionError(
                    f"cpqr against double precision on Gaussian separated "
                    f"norms at {where}: kernel dR {kern[0]:.3e}, aligned dQ "
                    f"{kern[1]:.3e}; plain version {plain[0]:.3e}, "
                    f"{plain[1]:.3e}; planted phase error dR {planted:.3e} "
                    f"(limit {tol})")
            wide["kernel"] = [max(x, y) for x, y in zip(wide["kernel"], kern)]
            wide["plain"] = [max(x, y) for x, y in zip(wide["plain"], plain)]
            wide["planted"] = min(wide["planted"], planted)
        key = str(dtype).split(".")[-1]
        w = worst.setdefault(key, [0.0] * 4)
        worst[key] = [max(w[0], rec / allow), max(w[1], orth / allow),
                      max(w[2], dq / tol), max(w[3], dr / rmax / tol)]
        if (dtype, m, b) == (torch.complex64, 93, 512):
            main_err = dr
    for dtype in (torch.complex64, torch.complex128):
        m, k = 93, 7
        a = (rng.normal(size=(37, m, k)) + 1j * rng.normal(size=(37, m, k))
             ) @ rng.normal(size=(37, k, m))
        a = torch.from_numpy(a).to("cuda", dtype)
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        torch.cuda.synchronize()
        rec, orth, low, _ = cpqr_identities(a, q, r, p)
        d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
        allow = 10 * m * CPQR_EPS[dtype]
        if not (torch.isfinite(q).all() and torch.isfinite(r).all()
                and rec <= allow and orth <= allow and low == 0.0
                and bool((d[:, k:] <= 10 * allow * d[:, :1]).all())):
            raise AssertionError(f"cpqr on rank-7 input at {dtype}: rec "
                                 f"{rec:.3e} orth {orth:.3e}")
    if routes != {("warp", cpqr_cuda.WARP_TEAMS), ("block", 1)}:
        raise AssertionError(f"cpqr routes checked: {routes}")
    kern, plain = wide["kernel"], wide["plain"]
    return main_err, "routes (route, matrices a block) " + ", ".join(
        f"{r} {mpb}" for r, mpb in sorted(routes)) + "; " + "; ".join(
        f"{k} rec {v[0]:.3f}, orth {v[1]:.3f} of 10 m eps, dQ {v[2]:.3f}, "
        f"dR {v[3]:.3f} of tol" for k, v in worst.items()) + (
        f"; Gaussian separated norms against double precision (complex64 "
        f"and float32, limit 1e-4): kernel dR {kern[0]:.3e}, aligned dQ "
        f"{kern[1]:.3e} (raw dQ {kern[2]:.3e}, not held); plain version "
        f"dR {plain[0]:.3e}, aligned dQ {plain[1]:.3e} (raw dQ "
        f"{plain[2]:.3e}); planted phase error 2^-8 dR >= "
        f"{wide['planted']:.3e}")


def masked_core(rng, b: int, m: int, dead_rows: int, dead_cols: int):
    """The low-rank stack's factors as its masks leave them,
    diag(Dl) Q diag(D) (complex): Q unitary (QR of a Gaussian), D and Dl
    decaying from 1 to 1e-2 with their last dead_cols and dead_rows entries
    zeroed exactly (dead_rows <= dead_cols: in the stack both are the
    high-energy directions; dead_rows = 0 is the boundary step's right
    factor), then rows and columns relabelled by one permutation, so that
    the dead columns are interspersed. The combine's G formula needs TQ
    invertible on the live block, i.e. no live output direction in the
    null space, which this structure keeps (independent row and column
    shuffles would not). Returns (a [b, m, m], the live-row mask [b, m])."""
    g = rng.normal(size=(b, m, m)) + 1j * rng.normal(size=(b, m, m))
    q = np.linalg.qr(g)[0]
    d = 1e-2 ** (np.arange(m) / (m - 1))
    dl = d.copy()
    d[m - dead_cols:] = 0.0
    dl[m - dead_rows:] = 0.0
    a = dl[None, :, None] * q * d[None, None, :]
    perm = rng.permutation(m)
    return (a[:, perm][:, :, perm],
            np.ascontiguousarray(np.broadcast_to(dl[perm] != 0, (b, m))))


def check_cpqr_masked(cpqr_cuda, low_rank, rng) -> str:
    """The cpqr kernel on the low-rank stack's masked input at (512, 93),
    complex64 and complex128: 20 dead columns zeroed exactly, with no dead
    row (the boundary step's right factor) and with 10 (the combine's
    core). The identities within 10 m eps, exact zeros below R's diagonal,
    finite factors, R's diagonal exactly 0 on each dead column and nonzero
    on every live one, in the kernel and in the plain version; then
    G = (1 + A)^-1 and log det(1 + A) of the low-rank combine
    (``_green_from_clcr``: the kernel and kernel B) against the same
    function on the host (the plain versions, the card's type; the first
    32 matrices, as a matrix's result does not depend on its neighbours)
    and against float64 numpy, within TOL of max|G| (tol m for the log-det,
    its phase modulo 2 pi, +-pi one value)."""
    out = []
    b, m, dead_cols, nhost = 512, 93, 20, 32
    live = m - dead_cols
    for dtype in (torch.complex64, torch.complex128):
        tol, allow = TOL[dtype], 10 * m * CPQR_EPS[dtype]
        worst = [0.0] * 6
        for dead_rows in (0, 10):
            a_np, mask_np = masked_core(rng, b, m, dead_rows, dead_cols)
            a = torch.from_numpy(a_np).to("cuda", dtype)
            where = f"{dtype} dead rows {dead_rows}"
            before = cpqr_cuda.launches
            q, r, p = cpqr_cuda.cpqr_lanes(a)
            qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(a)
            torch.cuda.synchronize()
            if cpqr_cuda.launches != before + 1:
                raise AssertionError(f"cpqr on masked input at {where}: no "
                                     f"launch")
            for name, (qq, rr, pq) in (("kernel", (q, r, p)),
                                       ("plain", (qp, rp, pp))):
                rec, orth, low, _ = cpqr_identities(a, qq, rr, pq)
                d = torch.diagonal(rr, dim1=-2, dim2=-1)
                if not (torch.isfinite(qq).all() and torch.isfinite(rr).all()
                        and rec <= allow and orth <= allow and low == 0.0
                        and bool((d[:, live:] == 0).all())
                        and bool((d[:, :live] != 0).all())):
                    raise AssertionError(
                        f"cpqr ({name}) on masked input at {where}: rec "
                        f"{rec:.3e} orth {orth:.3e} below-diagonal {low}, "
                        f"dead diagonal max "
                        f"{d[:, live:].abs().max().item():.3e}, live "
                        f"diagonal min {d[:, :live].abs().min().item():.3e}")
                if name == "kernel":
                    worst[:2] = [max(worst[0], rec / allow),
                                 max(worst[1], orth / allow)]
            eye = torch.eye(m, dtype=dtype, device="cuda").expand(b, m, m)
            mask = torch.from_numpy(mask_np)
            g_k, ld_k = low_rank._green_from_clcr(a, eye, mask.cuda(), 1e-6)
            g_h, ld_h = low_rank._green_from_clcr(
                a[:nhost].cpu(), eye[:nhost].cpu(), mask[:nhost], 1e-6)
            one_a = np.eye(m) + a.cpu().to(torch.complex128).numpy()
            sign, ld_64 = np.linalg.slogdet(one_a)
            g_k = g_k.cpu().to(torch.complex128).numpy()
            ld_k = ld_k.cpu().to(torch.complex128).numpy()
            for i, (g_ref, ld_ref) in enumerate((
                    (g_h.to(torch.complex128).numpy(),
                     ld_h.to(torch.complex128).numpy()),
                    (np.linalg.inv(one_a), ld_64 + 1j * np.angle(sign)))):
                nb = len(g_ref)
                dg = np.abs(g_k[:nb] - g_ref).max() / np.abs(g_ref).max()
                dld = ld_k[:nb] - ld_ref
                dre = np.abs(dld.real).max()
                dim = phase_diff(dld.imag).max()
                if not (np.isfinite(g_k).all() and dg <= tol
                        and dre <= tol * m and dim <= tol * m):
                    raise AssertionError(
                        f"low-rank G on masked input at {where} against "
                        f"{('the host', 'float64')[i]}: dG {dg:.3e}, "
                        f"dlogdet {dre:.3e} / {dim:.3e} (tol {tol})")
                worst[2 + 2 * i] = max(worst[2 + 2 * i], dg)
                worst[3 + 2 * i] = max(worst[3 + 2 * i], dre)
        out.append(f"{str(dtype).split('.')[-1]}: rec {worst[0]:.3f}, orth "
                   f"{worst[1]:.3f} of 10 m eps; dG / dRe log det vs the "
                   f"host {worst[2]:.2e} / {worst[3]:.2e}, vs float64 "
                   f"{worst[4]:.2e} / {worst[5]:.2e}")
    return "; ".join(out)


def low_rank_launches(nslices: int, stack_size: int,
                      npaths: int) -> tuple[int, int]:
    """(cpqr, kernel B) launches of ThermalAFQMC.run() with the low-rank
    walkers over npaths paths: the walker initialisation is a closed form
    (none); each slice pivots the combined core once and, on a stack
    boundary (ts % stack_size == stack_size - 1), the right factor once
    more; two kernel B passes a slice (inverse and log-det of the padded
    TQ, then of the core)."""
    return (npaths * (nslices + nslices // stack_size),
            2 * nslices * npaths)


def discrete_thermal_launches(nbins: int, stack_size: int, nslices: int,
                              npaths: int, free_projection: bool = False,
                              wrap_stabilize: int = 10) -> tuple[int, int]:
    """(cpqr, kernel B) launches of ThermalAFQMC.run() with the discrete
    propagator over npaths paths: each walker initialisation (at
    ThermalAFQMC's construction and the reset after every path) folds
    nbins bins and assembles G with its log-det (5 kernel B launches);
    the constrained path re-stratifies the nbins + 1 boundary factors (G
    only: 2 launches) on every slice with ts % stack_size == 0 or
    ts % wrap_stabilize == 0; free projection folds the stack and
    assembles G and log det G every slice."""
    if free_projection:
        per = (nslices * nbins, 5 * nslices)
    else:
        refresh = sum(ts % stack_size == 0 or ts % wrap_stabilize == 0
                      for ts in range(nslices))
        per = (refresh * (nbins + 1), 2 * refresh)
    return ((npaths + 1) * nbins + npaths * per[0],
            5 * (npaths + 1) + npaths * per[1])


def average_gf_launches(nbins: int, nmeasure: int) -> tuple[int, int]:
    """(cpqr, kernel B) launches that average_gf adds to nmeasure
    measurements: G at each of the nbins stack origins, nbins folds and two
    kernel B passes each."""
    return nmeasure * nbins * nbins, nmeasure * 2 * nbins


def exact_grand_canonical_hubbard_2site(u: float, t: float, beta: float,
                                        mu: float) -> tuple[float, float]:
    """<H> and <N> of the open 2-site Hubbard chain in the grand-canonical
    ensemble at beta, mu, by diagonalising its 16 Fock states (a numpy copy
    of the JAX package's test oracle)."""
    dim = 16

    def occ(state, spin, site):
        return (state >> (spin * 2 + site)) & 1

    h = np.zeros((dim, dim))
    nop = np.zeros(dim)
    for s in range(dim):
        nop[s] = sum(occ(s, sp, i) for sp in range(2) for i in range(2))
        h[s, s] += u * sum(occ(s, 0, i) * occ(s, 1, i) for i in range(2))
        h[s, s] -= mu * nop[s]
        for sp in range(2):
            for i, j in ((0, 1), (1, 0)):
                if occ(s, sp, j) and not occ(s, sp, i):
                    h[s ^ (1 << (sp * 2 + j)) ^ (1 << (sp * 2 + i)), s] -= t
    w, v = np.linalg.eigh(h)
    z = np.exp(-beta * w)
    n_diag = (v.conj().T @ np.diag(nop) @ v).diagonal().real
    return ((z * (w + mu * n_diag)).sum() / z.sum(),
            (z * n_diag).sum() / z.sum())


def check_batchla_thermal(batchla_cuda, clinalg, rng) -> str:
    """Kernel B at the thermal shape n=93 with 512 matrices and at its cap
    (37 matrices), in every type and both modes: the kernel launches and
    agrees with its plain version and with the augmented Gauss-Jordan of
    inv_logdet_lanes_plain; cap + 1 goes to torch.linalg by shape and agrees
    with it."""
    out = []
    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        tol, cap = TOL[dtype], batchla_cuda.inv_max_n(dtype)
        for n, w in ((93, 512), (cap, 37), (cap + 1, 37)):
            s = pivot_cases(rng, w, n, dtype.is_complex)
            s = torch.from_numpy(s).to("cuda", dtype)
            if n > cap:
                before = batchla_cuda.launches
                _, inv = clinalg.inv_logdet(s)
                clinalg.slogdet(s)
                want = torch.linalg.inv(s)
                torch.cuda.synchronize()
                d = ((inv - want).abs().max() / want.abs().max()).item()
                if batchla_cuda.launches != before or d > tol:
                    raise AssertionError(f"kernel B route at {dtype} n={n}")
                continue
            for want_inv in (True, False):
                before = batchla_cuda.launches
                ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
                if batchla_cuda.launches != before + 1:
                    raise AssertionError(f"kernel B at {dtype} n={n}: no "
                                         f"launch")
                dre, dim, rel = against_plains(batchla_cuda, s, want_inv,
                                               ld_k, inv_k)
                if dre > tol * n or dim > tol * n or rel > tol:
                    raise AssertionError(
                        f"inv_logdet_lanes disagrees at {dtype} n={n} w={w} "
                        f"want_inv={want_inv}: dRe={dre:.3e} dIm={dim:.3e} "
                        f"dinv/max={rel:.3e}")
        out.append(f"{str(dtype).split('.')[-1]} cap {cap}")
    return ", ".join(out)


def pivot_cases(rng, w: int, n: int, complex_: bool) -> np.ndarray:
    """2 I + 0.3 N / sqrt(n), with the matrices that need pivoting in the
    first slots: the reversed identity (zero leading minors), a cyclic
    shift, -I, a first column of exact ties in |a_i0| (entries +-1, +-i),
    and one of near ties (|a_i0| = 1 + 1e-7 d_i, random phases)."""
    s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * rng.normal(size=(w, n, n))
    units = np.array([1.0, -1.0])
    if complex_:
        s = s + 0.3j / np.sqrt(n) * rng.normal(size=(w, n, n))
        units = np.array([1, -1, 1j, -1j])
    specials = [np.eye(n)[::-1], np.roll(np.eye(n), 1, axis=0), -np.eye(n)]
    ties = s[0].copy()
    ties[:, 0] = rng.choice(units, n)
    near = s[0].copy()
    near[:, 0] = (1 + 1e-7 * rng.normal(size=n)) * (
        np.exp(1j * rng.uniform(0, 2 * np.pi, n)) if complex_
        else rng.choice(units, n))
    for i, m in enumerate((specials + [ties, near])[:w]):
        s[i] = m
    return s


# Exactly singular matrices and the log-determinant every route of the
# port gives them (a zero pivot: log 0 = -inf, a unit phase, nothing
# eliminated): name, matrix, arg det (mod 2 pi), whether JAX's CPU slogdet
# gives the same (a zero pivot before the last makes its later pivots 0/0).
ZERO_PIVOT_CASES = (
    ("[[1,0],[0,0]]", ((1, 0), (0, 0)), 0.0, True),
    ("[[2,1],[4,2]]", ((2, 1), (4, 2)), np.pi, True),
    ("[[i,2],[2i,4]]", ((1j, 2), (2j, 4)), -0.5 * np.pi, True),
    ("zeros", ((0, 0), (0, 0)), 0.0, False),
    ("diag(1,0,1)", ((1, 0, 0), (0, 0, 0), (0, 0, 1)), 0.0, False),
)


def zero_pivot_batch(dtype, w: int = 37):
    """[w, n, n] of ``dtype``: the cases of size n (complex ones only for a
    complex type) in the first slots, 2 I after; with the expected args."""
    out = []
    for n in (2, 3):
        cases = [(m, arg) for _, m, arg, _ in ZERO_PIVOT_CASES
                 if len(m) == n and (dtype.is_complex
                                     or not np.iscomplexobj(np.array(m)))]
        s = np.broadcast_to(2.0 * np.eye(n), (w, n, n)).astype(complex)
        for i, (m, _) in enumerate(cases):
            s[i] = np.array(m)
        s = torch.from_numpy(s if dtype.is_complex else s.real.copy())
        out.append((s.to(dtype), [arg for _, arg in cases]))
    return out


def check_zero_pivot(batchla_cuda, greens_cuda) -> str:
    """Kernel B (both modes, every type) on the exactly singular
    ZERO_PIVOT_CASES: log|det| -inf and arg det as listed, the 2 I after
    them exact; kernel A (complex, S = phi^T conj(psi) with psi the
    identity's first n columns; its two modes eliminate S and S^T, whose
    zero pivots give other phases) against its plain version: -inf with
    the same phase."""
    seen = 0

    def bad(ld, k, args, rest):
        return (not np.all(np.isneginf(ld.real[:k]))
                or phase_diff(ld.imag[:k] - np.asarray(args)).max() > 1e-6
                or np.abs(ld.real[k:] - rest).max() > 1e-5
                or np.abs(ld.imag[k:]).max() > 1e-6)

    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        for s, args in zero_pivot_batch(dtype):
            s = s.to("cuda")
            k, n = len(args), s.shape[-1]
            for want_inv in (True, False):
                ld = batchla_cuda.inv_logdet_lanes(s, want_inv)[0]
                ld = ld.cpu().numpy()
                if bad(ld, k, args, n * np.log(2.0)):
                    raise AssertionError(
                        f"kernel B zero pivot {dtype} n={n} want_inv="
                        f"{want_inv}: {ld[:k + 1]}, want -inf, args {args}")
                seen += k
            if not dtype.is_complex:
                continue
            psi = torch.eye(5, n, dtype=dtype, device="cuda")
            phi = torch.zeros(5, n, s.shape[0], dtype=dtype, device="cuda")
            phi[:n] = s.permute(2, 1, 0)
            for want_gh in (True, False):
                ld = greens_cuda.greens_lanes(psi, phi, want_gh)[0]
                ld_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)[0]
                ld, ld_p = ld.cpu().numpy(), ld_p.cpu().numpy()
                if bad(ld, k, ld_p.imag[:k], n * np.log(2.0)) or not \
                        np.all(np.isneginf(ld_p.real[:k])):
                    raise AssertionError(
                        f"kernel A zero pivot {dtype} n={n} want_gh="
                        f"{want_gh}: {ld[:k + 1]} vs plain {ld_p[:k + 1]}")
                seen += k
    return f"{seen} singular log-dets -inf with their phases"


def against_plains(batchla_cuda, s, want_inv, ld_k, inv_k):
    """(max |dRe logdet|, max |dIm logdet| mod 2 pi, max |d inv| / max|inv|)
    of the kernel's output against its plain version (in-place
    Gauss-Jordan / LU, the kernel's order) and against the augmented
    Gauss-Jordan of inv_logdet_lanes_plain (an independent elimination
    order)."""
    dre = dim = rel = 0.0
    for plain in (batchla_cuda.inv_logdet_plain,
                  batchla_cuda.inv_logdet_lanes_plain):
        ld_p, inv_p = plain(s, want_inv)
        torch.cuda.synchronize()
        d = (ld_k - ld_p).cpu().numpy()
        dre = max(dre, float(np.abs(d.real).max()))
        dim = max(dim, float(phase_diff(d.imag).max()))
        if want_inv:
            if inv_k.dtype != s.dtype:
                raise AssertionError(f"inverse of {s.dtype} input came back "
                                     f"{inv_k.dtype}")
            rel = max(rel, float((inv_k - inv_p).abs().max()
                                 / inv_p.abs().max()))
    if not s.dtype.is_complex:
        im = np.abs(ld_k.imag.cpu().numpy())
        if not np.all((im == 0) | (np.abs(im - np.pi) < 1e-6)):
            raise AssertionError("real log-det phase not 0/pi")
    return dre, dim, rel


def thermal_launches(nbins: int, stack_size: int, nslices: int,
                     npaths: int) -> tuple[int, int]:
    """(cpqr, kernel B) launches of ThermalAFQMC.run() over npaths paths:
    each walker initialisation (the driver's and the reset after every
    path) folds all nbins bins and assembles G once (5 kernel B launches:
    two inverses, three log-dets); each slice ts folds bins
    ts // stack_size .. nbins - 1, plus one prefix fold on entering bins
    1.., and assembles G once."""
    per_path = sum(nbins - ts // stack_size
                   + (ts % stack_size == 0 and ts >= stack_size)
                   for ts in range(nslices))
    return ((npaths + 1) * nbins + npaths * per_path,
            5 * (npaths + 1) + 5 * nslices * npaths)


def thermal_injected(af, xi: np.ndarray, pop: np.ndarray, PathNoise):
    """One path of ``af`` with injected draws; its row."""
    dev, rdt = af.state.weight.device, af.state.weight.dtype
    return af.run_block(PathNoise(torch.from_numpy(xi).to(dev, rdt),
                                  torch.from_numpy(pop).to(dev, rdt)))


def phase_diff(a: np.ndarray) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * a)))


def check_greens(greens_cuda, rng) -> float:
    """Kernel A against its plain version at (M, n) in {(4, 1), (9, 3),
    (16, 7), (36, 18), (64, 24)} x W in {1, 100, 1024, 1031}, both types
    and modes (staged in shared memory at these shapes); returns the
    largest absolute difference at the main-path shape (complex64, with
    ghT)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        for m, n in ((4, 1), (9, 3), (16, 7), (36, 18), (64, 24)):
            for w in (1, 100, 1024, 1031):
                psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
                phi = psi[:, :, None] + 0.3 * (
                    rng.normal(size=(m, n, w)) + 1j * rng.normal(size=(m, n, w)))
                psi = torch.from_numpy(psi).to("cuda", dtype)
                phi = torch.from_numpy(phi).to("cuda", dtype)
                for want_gh in (True, False):
                    ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
                    ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi,
                                                                want_gh)
                    torch.cuda.synchronize()
                    d = (ld_k - ld_p).cpu().numpy()
                    dre = float(np.abs(d.real).max())
                    dim = float(phase_diff(d.imag).max())
                    dgh = rel = 0.0
                    if want_gh:
                        dgh = float((gh_k - gh_p).abs().max())
                        rel = dgh / float(gh_p.abs().max())
                    if dre > tol * n or dim > tol * n or rel > tol:
                        raise AssertionError(
                            f"greens_lanes disagrees at {dtype} M={m} n={n} "
                            f"W={w} want_gh={want_gh}: dRe={dre:.3e} "
                            f"dIm={dim:.3e} dghT/max={rel:.3e}")
                    if (dtype == torch.complex64 and (m, n, w) == (16, 7, 1024)
                            and want_gh):
                        main_err = max(dre, dim, dgh)
    return main_err


def check_batchla(batchla_cuda, rng) -> float:
    """Kernel B against its plain version, complex and real input,
    including matrices that need pivoting (pivot_cases) and negative
    determinants, from n=1 up to the Generic paths' shapes (n=16 with 1024
    walkers, n=42 with 256) and n=64;
    returns the largest absolute difference at the main-path shape
    (complex64, n=7, w=1024, log-det only)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        tol = TOL[dtype]
        for n, w in ((1, 1024), (2, 1024), (3, 1024), (5, 1024), (7, 1024),
                     (16, 1024), (18, 1024), (32, 512), (42, 256),
                     (64, 512)):
            s = pivot_cases(rng, w, n, dtype.is_complex)
            s = torch.from_numpy(s).to("cuda", dtype)
            for want_inv in (True, False):
                ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
                dre, dim, rel = against_plains(batchla_cuda, s, want_inv,
                                               ld_k, inv_k)
                if dre > tol * n or dim > tol * n or rel > tol:
                    raise AssertionError(
                        f"inv_logdet_lanes disagrees at {dtype} n={n} "
                        f"want_inv={want_inv}: dRe={dre:.3e} dIm={dim:.3e} "
                        f"dinv/max={rel:.3e}")
                if dtype == torch.complex64 and n == 7 and not want_inv:
                    main_err = max(dre, dim)
    return main_err


def scaled_err(a, b, s, tol) -> np.ndarray:
    """Per matrix: max|a_w - b_w| over its allowance
    max(tol, 2 n eps kappa(S_w)) max|b_w| (two stable inverses differ by
    about eps kappa |S^-1|; kappa the 2-norm condition number)."""
    n = s.shape[-1]
    eps = torch.finfo(s.dtype).eps
    kappa = np.linalg.cond(s.cpu().double().numpy())
    err = (a - b).abs().amax((1, 2)).cpu().double().numpy()
    scale = b.abs().amax((1, 2)).cpu().double().numpy()
    return err / (np.maximum(tol, 2 * n * eps * kappa) * scale)


def check_batchla_ill(batchla_cuda, rng) -> str:
    """Kernel B on ill-conditioned real input, 2 I + 0.5 N (eigenvalues
    near zero, as the sweep's real S = psi^T phi may have), at n = 5, 7,
    18, 42 and 93: the kernel against its plain version and against the
    float64 inverse, matrix by matrix within the error that conditioning
    allows. Returns a summary:
    the largest condition number, and the largest error of each float32
    inverse against the float64 one in units of eps kappa max|S^-1|."""
    out = []
    for dtype in (torch.float32, torch.float64):
        for n, w in ((5, 1031), (7, 1031), (18, 1031), (42, 1031),
                     (93, 512)):
            s = 2.0 * np.eye(n) + 0.5 * rng.normal(size=(w, n, n))
            s = torch.from_numpy(s).to("cuda", dtype)
            _, inv_k = batchla_cuda.inv_logdet_lanes(s)
            _, inv_p = batchla_cuda.inv_logdet_plain(s)
            truth64 = torch.linalg.inv(s.double())
            truth = truth64.to(dtype)
            torch.cuda.synchronize()
            worst = max(scaled_err(inv_k, inv_p, s, TOL[dtype]).max(),
                        scaled_err(inv_k, truth, s, TOL[dtype]).max())
            if worst > 1.0:
                raise AssertionError(
                    f"inv_logdet_lanes on ill-conditioned {dtype} n={n}: "
                    f"error {worst:.3f} of its allowance")
            if dtype == torch.float32:
                kappa = np.linalg.cond(s.cpu().double().numpy())
                eps = torch.finfo(dtype).eps

                def units(a):
                    err = (a.double() - truth64).abs().amax((1, 2))
                    err = err.cpu().numpy()
                    mx = truth64.abs().amax((1, 2)).cpu().numpy()
                    return float((err / (eps * kappa * mx)).max())
                out.append(f"n={n} max kappa {kappa.max():.4g}: kernel "
                           f"{units(inv_k):.4f}, plain {units(inv_p):.4f}")
    return "; ".join(out)


def hpd(rng, w: int, n: int) -> np.ndarray:
    phi = rng.normal(size=(w, 2 * n, n)) + 1j * rng.normal(size=(w, 2 * n, n))
    return np.conj(np.swapaxes(phi, 1, 2)) @ phi


def check_chol(batchla_cuda, rng) -> float:
    """The Cholesky-inverse kernel against its plain version on both routes
    and their edges (the lanes route up to n = 32, the block route from 33
    up to the largest n it launches), at the Generic paths' shapes (n=16
    with 1024 walkers, n=42 with 256), with ragged walker counts; returns
    the largest absolute difference at the main-path shape (complex64, n=7,
    w=1024)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        cap = batchla_cuda.chol_max_n(dtype)
        for n in (1, 3, 7, 16, 24, 31, 32, 33, 42, 48, cap):
            ws = {cap: (1, 37), 42: (1, 256, 1031)}.get(n, (1, 1024, 1031))
            for w in ws:
                s = torch.from_numpy(hpd(rng, w, n)).to("cuda", dtype)
                ld_k, l_k = batchla_cuda.chol_inv_lanes(s)
                ld_p, l_p = batchla_cuda.chol_inv_lanes_plain(s)
                torch.cuda.synchronize()
                dld = float((ld_k - ld_p).abs().max())
                dl = float((l_k - l_p).abs().max())
                if dld > tol * n or dl > tol * float(l_p.abs().max()):
                    raise AssertionError(
                        f"chol_inv_lanes disagrees at {dtype} n={n} W={w} "
                        f"({batchla_cuda.chol_plan(n, dtype).route}): "
                        f"dlogdetL={dld:.3e} dLinv={dl:.3e}")
                if dtype == torch.complex64 and (n, w) == (7, 1024):
                    main_err = max(dld, dl)
    return main_err


def chol_two_calls(s):
    """The two PyTorch calls that compute the Cholesky kernel's function,
    the route ops/clinalg.cholesky_qr takes past the kernel's cap:
    L = cholesky(S), then L^-1 = solve_triangular(L, I) (log det L is one
    more, small reduction)."""
    l = torch.linalg.cholesky(s)
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    return torch.linalg.solve_triangular(l, eye.expand_as(s), upper=False)


def sweep_inputs(rng, m, na, nb, w, dtype):
    """Walkers near an orthonormal trial, the spin tables of dt=0.01, U=4,
    and a seventh of the walkers dead (weight 0)."""
    psia = np.linalg.qr(rng.normal(size=(m, na)))[0]
    psib = np.linalg.qr(rng.normal(size=(m, nb)))[0]
    phia = psia[None] + 0.1 * rng.normal(size=(w, m, na))
    phib = psib[None] + 0.1 * rng.normal(size=(w, m, nb))
    inva = np.linalg.inv(np.einsum("mi,wmj->wij", psia, phia))
    invb = np.linalg.inv(np.einsum("mi,wmj->wij", psib, phib))
    g = np.arccosh(np.exp(0.5 * 0.01 * 4.0))
    delta = np.exp(-0.02) * np.array([[np.exp(g), np.exp(-g)],
                                      [np.exp(-g), np.exp(g)]]) - 1.0
    weight = np.ones(w)
    weight[::7] = 0.0
    args = (psia, psib, delta, np.ones(2), phia, phib, inva, invb,
            rng.uniform(size=(m, w)), weight)
    return [torch.from_numpy(a).to("cuda", dtype) for a in args]


# (M, na, nb) of the sweep kernel's check at W in {1, 37, 1024, 1031}; the
# Hubbard-Holstein anchors' small lattices (the single-site polaron, the
# 3-site ring, the 4-site chain) at W in {1, 37, 200}.
SWEEP_SHAPES = (((9, 3, 3), (16, 7, 7), (9, 4, 2), (36, 18, 18),
                 (36, 17, 5), (36, 32, 32)), (1, 37, 1024, 1031))
SWEEP_SHAPES_HH = (((1, 1, 1), (3, 1, 1), (4, 2, 2)), (1, 37, 200))


def check_sweep(sweep_cuda, rng) -> float:
    """The sweep kernel against its plain version, up to na = nb = 32
    (one warp a walker), at na != nb and at the Hubbard-Holstein anchors'
    shapes: outputs within the tolerance, fields identical; returns the
    largest absolute difference at the main-path shape (float32,
    (16, 7, 7), W=1024)."""
    main_err = None
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for m, na, nb, w in ((m, na, nb, w)
                             for shapes, ws in (SWEEP_SHAPES,
                                                SWEEP_SHAPES_HH)
                             for m, na, nb in shapes for w in ws):
            args = sweep_inputs(rng, m, na, nb, w, dtype)
            out_k = sweep_cuda.hirsch_sweep_real(*args)
            out_p = sweep_cuda.hirsch_sweep_real_plain(*args)
            torch.cuda.synchronize()
            err = 0.0
            for k, p in zip(out_k[:4], out_p[:4]):
                d = float((k - p).abs().max())
                err = max(err, d)
                if d > tol * max(float(p.abs().max()), 1.0):
                    raise AssertionError(
                        f"hirsch_sweep disagrees at {dtype} "
                        f"(M,na,nb)=({m},{na},{nb}) W={w}: {d:.3e}")
            if not torch.equal(out_k[4], out_p[4]):
                nd = int((out_k[4] != out_p[4]).sum())
                raise AssertionError(
                    f"hirsch_sweep fields differ at {dtype} "
                    f"(M,na,nb)=({m},{na},{nb}) W={w}: {nd} of "
                    f"{m * w}")
            if dtype == torch.float32 and (m, na, w) == (16, 7, 1024):
                main_err = err
    return main_err


# The Generic paths' shapes, the UEG bench class (M = 257, 7 + 7 columns)
# and each type's cap (taylor_cuda.max_m) with the same columns.
TAYLOR_SHAPES = ((16, 14), (128, 32), (228, 84), (257, 14), ("cap", 14))
# The listed exchange shapes, then two whose walker exceeds a block's
# shared memory (the kernel stages column chunks; n = 130 takes its pair
# tiles in several rounds).
EXX_SHAPES = ((30, 3, 12), (512, 16, 128), (1024, 42, 228), (8, 60, 500),
              (4, 130, 200))
# The exchange kernel against its plain version computed in float64 on the
# same inputs, per walker, in units of S_w. The float32 plain version is no
# yardstick at this scale: its reduction of X n^2 same-sign products in
# long float32 sums errs by up to ~1e-5 S_w on coherent inputs, where the
# kernel's short per-thread sums err by ~2e-7 S_w (an emulation of its
# summation order in numpy at (1024, 42, 228)). A kernel that drops one of
# X Cholesky vectors misses by about S_w / X on coherent inputs (1e-3 at
# X = 1024) and S_w / (X n) on random phases.
EXX_TOL = {torch.complex64: 5e-6, torch.complex128: 1e-13}
RDTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def taylor_inputs(gen, w, m, ncol, dtype):
    """VHS of spectral norm ~0.6 (as the bench shape's) and walkers."""
    vhs = (0.3 / m ** 0.5) * torch.randn((w, m, m), generator=gen,
                                         dtype=dtype, device="cuda")
    phi = torch.randn((w, m, ncol), generator=gen, dtype=dtype,
                      device="cuda")
    return vhs, phi


def exx_inputs(gen, x, n, m, w, dtype, coherent=False):
    """Random phases (exx cancels: |exx_w| << S_w) or coherent ones (real
    positive rchol, Ghalf near real positive: |exx_w| ~ S_w)."""
    rc = torch.randn((x, n, m), generator=gen, dtype=RDTYPE[dtype],
                     device="cuda") / m ** 0.5
    gh = torch.randn((w, n, m), generator=gen, dtype=dtype, device="cuda")
    if coherent:
        rc = rc.abs()
        gh = (gh.real.abs() + 0.1j * gh.imag).to(dtype)
    return rc, gh


def check_taylor(taylor_cuda, gen) -> float:
    """The Taylor kernel against its plain version: max|d| <= tol max|out|;
    returns the largest absolute difference at the main-path shape
    ((M, C) = (128, 32), w=1024, complex64)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        for m, ncol in TAYLOR_SHAPES:
            if m == "cap":
                m = taylor_cuda.max_m(dtype)
            for w in (1, 37, 1024):
                vhs, phi = taylor_inputs(gen, w, m, ncol, dtype)
                before = taylor_cuda.launches
                out_k = taylor_cuda.apply_taylor(vhs, phi)
                if taylor_cuda.launches != before + 1:
                    raise AssertionError(f"apply_taylor at M={m}: no launch")
                out_p = taylor_cuda.apply_taylor_plain(vhs, phi)
                torch.cuda.synchronize()
                err = float((out_k - out_p).abs().max())
                if err > TOL[dtype] * float(out_p.abs().max()):
                    raise AssertionError(
                        f"apply_taylor disagrees at {dtype} (M,C)=({m},"
                        f"{ncol}) w={w}: {err:.3e}")
                if dtype == torch.complex64 and (m, w) == (128, 1024):
                    main_err = err
                del vhs, phi, out_k, out_p
    return main_err


# The bf16 tier's shapes: the UEG golden (M = 33) and bench (M = 257)
# classes with both spins' 14 columns, the Generic bench class, the upper
# edge of each cluster size of the resident route at C = 14 (208: 1 CTA a
# walker, 288: 2, 384: 4, 512: 8), just past its cap (513, streaming), a
# wider column part at the bench M, and the bf16 kernel's cap
# (taylor_cuda.max_m_bf16, streaming).
TAYLOR_BF16_SHAPES = ((33, 14), (128, 32), (257, 14), (208, 14), (288, 14),
                      (384, 14), (512, 14), (513, 14), (257, 32), ("cap", 14))
# Where the resident route also runs the streaming kernel, forced.
TAYLOR_BF16_STREAMING = ((33, 14), (257, 14))


def bf16_routes(taylor_cuda) -> tuple[int, int]:
    return (taylor_cuda.launches_bf16_resident,
            taylor_cuda.launches_bf16_streaming)


def check_taylor_bf16(taylor_cuda, gen) -> tuple[float, str]:
    """The bf16 Taylor kernel against its plain version (the same bf16
    roundings, float32 sums in another order) on the same card tensors:
    max|d| <= 1e-3 max|out| at every shape and w in {1, 37, 512}
    (complex64; complex128, cast to float32 planes as JAX casts it, at
    M = 257), each launch on the route route_bf16 names (and the
    streaming kernel forced where the resident route runs); at M = cap + 1
    the bf16 tier takes its plain series by shape, without a launch.
    Returns the largest |d| at the bench shape ((257, 14), w=512,
    complex64) and the readings."""
    from pauxy_tpu_torch.propagation.generic import taylor_series

    main_err, worst = None, {}
    cases = [(m, c, torch.complex64, None) for m, c in TAYLOR_BF16_SHAPES]
    cases.append((257, 14, torch.complex128, None))
    cases += [(m, c, torch.complex64, "streaming")
              for m, c in TAYLOR_BF16_STREAMING]
    for m, ncol, dtype, forced in cases:
        if m == "cap":
            m = taylor_cuda.max_m_bf16()
        route = forced or taylor_cuda.route_bf16(m, ncol).route
        for w in (1, 37, 512):
            vhs, phi = taylor_inputs(gen, w, m, ncol, dtype)
            before = (taylor_cuda.launches_bf16, *bf16_routes(taylor_cuda))
            if forced:
                out_k = taylor_cuda._apply_taylor_bf16(vhs, phi, 6,
                                                       route=forced)
            else:
                out_k = taylor_cuda.apply_taylor(vhs, phi, lowp=True)
            resident = route == "resident"
            want = (before[0] + 1, before[1] + resident,
                    before[2] + (not resident))
            if (taylor_cuda.launches_bf16,
                    *bf16_routes(taylor_cuda)) != want:
                raise AssertionError(f"bf16 Taylor at M={m}: no launch on "
                                     f"the {route} route")
            out_p = taylor_cuda.apply_taylor_plain(vhs, phi, lowp=True)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            rel = err / float(out_p.abs().max())
            if out_k.dtype != dtype or rel > 1e-3:
                raise AssertionError(
                    f"bf16 Taylor disagrees at {dtype} (M,C)=({m},{ncol}) "
                    f"w={w}: {rel:.3e} of max|out|")
            key = (f"({m},{ncol}){'' if dtype == torch.complex64 else ' c128'}"
                   f" {route}")
            worst[key] = max(worst.get(key, 0.0), rel)
            if (m, w, dtype, forced) == (257, 512, torch.complex64, None):
                main_err = err
            del vhs, phi, out_k, out_p
    m = taylor_cuda.max_m_bf16() + 1
    vhs, phi = taylor_inputs(gen, 3, m, 14, torch.complex64)
    before = taylor_cuda.launches_bf16
    got = taylor_series(vhs, phi, 6, "pallas_bf16")
    want = taylor_cuda.apply_taylor_plain(vhs, phi, lowp=True)
    torch.cuda.synchronize()
    if taylor_cuda.launches_bf16 != before or not torch.equal(got, want):
        raise AssertionError(f"bf16 Taylor route at M={m}: launched or "
                             f"not the plain series")
    return main_err, ", ".join(f"{k} {v:.3e}" for k, v in worst.items())


def check_taylor_route(taylor_cuda, GenericContinuous, gen) -> str:
    """The Generic propagator's "pallas" route at M = cap + 1 (each type):
    no launch, and the plain series' result within TOL."""
    out = []
    for dtype in (torch.complex64, torch.complex128):
        m = taylor_cuda.max_m(dtype) + 1
        chol = 0.01 * torch.randn((m, m, 1), generator=gen,
                                  dtype=RDTYPE[dtype], device="cuda")
        prop = GenericContinuous(
            torch.zeros(2, m, m, dtype=dtype, device="cuda"),
            torch.zeros(1, dtype=dtype, device="cuda"), chol, dt=0.01,
            taylor_impl="pallas")
        phia = torch.randn((3, m, 7), generator=gen, dtype=dtype,
                           device="cuda")
        phib = torch.randn((3, m, 7), generator=gen, dtype=dtype,
                           device="cuda")
        before = taylor_cuda.launches
        a, b = prop.apply_vhs(phia, phib,
                              torch.ones(3, 1, dtype=dtype, device="cuda"))
        vhs = ((1j * 0.1) * chol[..., 0].to(dtype))[None].expand(3, m, m)
        want = taylor_cuda.apply_taylor_plain(vhs, torch.cat([phia, phib],
                                                             -1))
        torch.cuda.synchronize()
        err = float((torch.cat([a, b], -1) - want).abs().max()
                    / want.abs().max())
        if taylor_cuda.launches != before or err > TOL[dtype]:
            raise AssertionError(f"Taylor route at {dtype} M={m}: "
                                 f"{taylor_cuda.launches - before} launches, "
                                 f"error {err:.3e}")
        out.append(f"{str(dtype).split('.')[-1]} cap {m - 1}")
    return ", ".join(out)


def check_greens_route(greens_cuda, rng) -> str:
    """Kernel A at n = max_n (each type and mode, M = 4 n, W in {1, 100,
    1024, 1031}; phi read from device memory, not staged) launches and
    agrees with its plain version; at max_n + 1 (37 walkers) it launches
    nothing and returns the plain version's result."""
    out = []
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        for want_gh in (True, False):
            cap = greens_cuda.max_n(dtype, want_gh)
            for n, w in ((cap, 1), (cap, 100), (cap, 1024), (cap, 1031),
                         (cap + 1, 37)):
                m = 4 * n
                psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
                phi = psi[:, :, None] + 0.3 * (
                    rng.normal(size=(m, n, w))
                    + 1j * rng.normal(size=(m, n, w)))
                psi = torch.from_numpy(psi).to("cuda", dtype)
                phi = torch.from_numpy(phi).to("cuda", dtype)
                before = greens_cuda.launches
                ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
                launched = greens_cuda.launches - before
                ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi,
                                                            want_gh)
                torch.cuda.synchronize()
                d = (ld_k - ld_p).cpu().numpy()
                dre = float(np.abs(d.real).max())
                dim = float(phase_diff(d.imag).max())
                rel = 0.0
                if want_gh:
                    rel = float((gh_k - gh_p).abs().max()
                                / gh_p.abs().max())
                where = f"{dtype} n={n} W={w} want_gh={want_gh}"
                if launched != (1 if n == cap else 0):
                    raise AssertionError(f"greens_lanes route at {where}: "
                                         f"{launched} launches")
                if dre > tol * n or dim > tol * n or rel > tol:
                    raise AssertionError(
                        f"greens_lanes disagrees at {where}: dRe={dre:.3e} "
                        f"dIm={dim:.3e} dghT/max={rel:.3e}")
            out.append(f"{str(dtype).split('.')[-1]} "
                       f"{'G' if want_gh else 'log-det'} cap {cap}")
    return ", ".join(out)


def check_exx(exx_cuda, gen) -> tuple[float, dict]:
    """The exchange kernel against its plain version in float64, walker by
    walker: |d_w| <= EXX_TOL S_w, S_w = sum_x sum_ij |T_ij||T_ji|, on
    random-phase and coherent inputs; the same bits on a second launch; and
    on coherent inputs the same inputs without their first Cholesky vector
    (what a kernel that drops one vector returns) must miss the allowance
    (on random phases that reading is recorded). Returns the largest
    absolute difference at the main-path shape ((X, n, M) = (1024, 42, 228),
    w=256, complex64, random phases) and, by type, the largest reading
    max_w |d_w| / S_w of the kernel and of the plain version in its own
    type, and the smallest readings of the dropped vector on random and
    coherent phases."""
    main_err = None
    readings = {}
    for dtype in (torch.complex64, torch.complex128):
        sound, plain, dropped = 0.0, 0.0, [float("inf"), float("inf")]
        for x, n, m in EXX_SHAPES:
            for coherent in (False, True):
                for w in (1, 37, 256):
                    rc, gh = exx_inputs(gen, x, n, m, w, dtype, coherent)
                    out_k = exx_cuda.exx(rc, gh)
                    again = exx_cuda.exx(rc, gh)
                    drop = exx_cuda.exx(rc[1:].contiguous(), gh)
                    out_p = exx_cuda.exx_plain(rc.double(),
                                               gh.to(torch.complex128))
                    own = exx_cuda.exx_plain(rc, gh)
                    scale = exx_cuda.exx_magnitude(rc, gh)
                    torch.cuda.synchronize()
                    err = (out_k - out_p).abs()
                    reading = float((err / scale).max())
                    plain = max(plain, float(((own - out_p).abs()
                                              / scale).max()))
                    miss = float(((drop - out_p).abs() / scale).max())
                    where = (f"{dtype} (X,n,M)=({x},{n},{m}) w={w} "
                             f"coherent={coherent}")
                    if reading > EXX_TOL[dtype]:
                        raise AssertionError(f"exx disagrees at {where}: "
                                             f"max |d_w|/S_w {reading:.3e}")
                    if coherent and miss <= EXX_TOL[dtype]:
                        raise AssertionError(f"exx criterion misses a "
                                             f"dropped vector at {where}: "
                                             f"{miss:.3e}")
                    if not torch.equal(out_k, again):
                        raise AssertionError(f"exx not reproducible at "
                                             f"{where}")
                    sound = max(sound, reading)
                    dropped[coherent] = min(dropped[coherent], miss)
                    if (dtype == torch.complex64 and (x, w) == (1024, 256)
                            and not coherent):
                        main_err = float(err.max())
        readings[str(dtype).split(".")[-1]] = (sound, plain, dropped)
    return main_err, readings


def generic_arrays(nmo: int, naux: int):
    """bench.py:317-330's random Hamiltonian (numpy default_rng(7), chol
    scale 0.01 and h1 scale 0.1, both symmetrised, ecore 0): (h1 [M, M],
    chol [M, M, X]) in float64."""
    rng = np.random.default_rng(7)
    chol = rng.normal(scale=0.01, size=(nmo, nmo, naux))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.1, size=(nmo, nmo))
    return 0.5 * (h1 + h1.T), chol


def generic_model(nmo: int, naux: int, nel: int, make_generic,
                  device: str = "cuda", dtype: str = "single"):
    """``generic_arrays``' system, by default on the card in
    complex64/float32."""
    h1, chol = generic_arrays(nmo, naux)
    return make_generic((nel, nel), np.stack([h1, h1]), chol, ecore=0.0,
                        device=device, dtype=dtype)


def reblocked_se(x: np.ndarray) -> float:
    """Standard error of a correlated series by Flyvbjerg-Petersen
    blocking, at the first level where successive estimates agree within
    their errors (pauxy_tpu/analysis/blocking.py's rule)."""
    x = np.asarray(x, dtype=float)
    ses, errs = [], []
    while len(x) >= 2:
        se = x.std(ddof=1) / np.sqrt(len(x))
        ses.append(se)
        errs.append(se / np.sqrt(2.0 * (len(x) - 1)))
        if len(x) < 4:
            break
        x = 0.5 * (x[: len(x) // 2 * 2: 2] + x[1: len(x) // 2 * 2: 2])
    for i in range(len(ses) - 1):
        if abs(ses[i + 1] - ses[i]) <= errs[i + 1] + errs[i]:
            return ses[i]
    return ses[-1]


def injected_blocks(af, xi: np.ndarray, pop: np.ndarray, nblocks: int,
                    run_block, BlockNoise, mixed) -> np.ndarray:
    """Per block (ETotal, summed unscaled weight) of ``af``'s path driven
    through run_block with injected draws: xi [nblocks * nsteps, w, X]
    fields and pop [nblocks * nsteps, 1] comb uniforms; the shift held at
    the trial energy."""
    q = af.qmc
    dev, rdt = af.state.weight.device, af.state.weight.dtype
    state, out = af.state, []
    for b in range(nblocks):
        steps = slice(b * q.nsteps, (b + 1) * q.nsteps)
        noise = BlockNoise(torch.from_numpy(xi[steps]).to(dev, rdt),
                           torch.from_numpy(pop[steps]).to(dev, rdt))
        state, acc, _, _ = run_block(
            af.ham, af.trial, af.prop, state, None, float(af.trial.etrial),
            b * q.nsteps, nsteps=q.nsteps, nstblz=q.nstblz,
            npop_control=q.npop_control, pop_method=q.pop_control_method,
            target_weight=float(q.nwalkers), energy_eval_freq=1, noise=noise)
        z = acc.cpu().double().numpy()
        z = z[0] + 1j * z[1]
        out.append(((z[mixed.ENUMER] / z[mixed.EDENOM]).real,
                    z[mixed.UWEIGHT].real))
    return np.array(out)


def extras_blocks(af, xi, pop: np.ndarray, nblocks: int, run_block,
                  BlockNoise, est: np.ndarray | None = None) -> list:
    """``af``'s path driven through run_block with injected draws, with its
    back-propagation / ITCF settings and free projection: per block the
    (mixed, BP, ITCF) sums as complex numpy arrays. ``xi`` holds one
    propagator draw per step: an array (the sweep's uniforms [M, w], the
    direct update's [w, M], free-projection bits [w, M] or HS fields
    [w, X]) or a list of NamedTuples of arrays (``DMCDraws``,
    ``RIDraws``); ``pop`` one comb uniform per step; ``est`` the
    stochastic-RI energy's probes [steps, X, S]; the shift is the trial
    energy."""
    q = af.qmc
    dev, rdt = af.state.weight.device, af.state.weight.dtype
    state, out = af.state, []
    for b in range(nblocks):
        steps = slice(b * q.nsteps, (b + 1) * q.nsteps)
        xs = xi[steps]
        noise = BlockNoise(
            to_device(xs, dev, rdt) if isinstance(xs, np.ndarray)
            else [to_device(x, dev, rdt) for x in xs],
            to_device(pop[steps], dev, rdt),
            None if est is None else to_device(est[steps], dev, rdt))
        state, *accs = run_block(
            af.ham, af.trial, af.prop, state, None, float(af.trial.etrial),
            b * q.nsteps, nsteps=q.nsteps, nstblz=q.nstblz,
            npop_control=q.npop_control, pop_method=q.pop_control_method,
            target_weight=float(q.nwalkers),
            energy_eval_freq=af.energy_eval_freq,
            free_projection=af.free_projection,
            calc_one_rdm=af.calc_one_rdm, calc_two_rdm=af.calc_two_rdm,
            extras=af.extras, noise=noise)
        out.append([(lambda z: z[0] + 1j * z[1])(a.cpu().double().numpy())
                    for a in accs])
    return out


def extras_gap(card: list, host: list) -> list:
    """Per accumulator (mixed, BP, ITCF): max |card - host| over the
    blocks over the largest |host| entry (0 for an estimator that is
    off)."""
    gaps = []
    for k in range(3):
        c = np.array([b[k] for b in card])
        h = np.array([b[k] for b in host])
        gaps.append(float(np.abs(c - h).max() / np.abs(h).max())
                    if h.size else 0.0)
    return gaps


def to_device(x, dev, rdt):
    """A numpy array, or a NamedTuple of them (None entries kept), as
    tensors of the real type ``rdt`` on ``dev``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(to_device(a, dev, rdt) for a in x))
    return torch.from_numpy(np.asarray(x)).to(dev, rdt)


def hh_schedule(nsteps: int, nstblz: int, energy_every: int,
                mc: bool) -> dict:
    """Launches of a Hubbard-Holstein run of ``nsteps`` steps. Coherent
    state: the discrete step's (``discrete_schedule``; the phonon moves
    launch no kernel). Multi-coherent (one [w P, n, n] batch a spin each
    time): kernel B 2 at set-up, 4 in the half-steps, 2 for the sweep's
    S_p^-1, 2 per phonon move (the electron log-dets, shared by X and X'),
    2 per energy (the Green's functions, whose weights give the phonon
    mixture too); no sweep kernel. Cholesky 4 per re-orthogonalisation."""
    if not mc:
        return discrete_schedule(nsteps, nstblz, energy_every, 0, 0, True,
                                 True)
    kb = 2 + 8 * nsteps + 2 * (nsteps // energy_every)
    return {"inv_logdet_lanes": kb, "chol_inv_lanes": 4 * (nsteps // nstblz)}


def hh_draws(rng, nsteps: int, nw: int, m: int, symmetric: bool,
             DMCDraws) -> list:
    """One ``DMCDraws`` of numpy arrays a step: the sweep's uniforms
    [M, w] and the phonon moves' normals [w, M]."""
    return [DMCDraws(rng.uniform(size=(m, nw)), rng.normal(size=(nw, m)),
                     rng.normal(size=(nw, m)) if symmetric else None)
            for _ in range(nsteps)]


class Pushed:
    """A stand-in for the HDF5 output of MixedReporter: keeps each block's
    pushed arrays by dataset name (the card's machine has no h5py)."""

    def __init__(self):
        self.blocks = [{}]

    def push(self, data, name: str) -> None:
        self.blocks[-1][name] = np.asarray(data)

    def increment(self) -> None:
        self.blocks.append({})


def rotated_msd_psi(m: int, na: int, nb: int, ndets: int, seed: int):
    """(psi [D, M, na + nb], coeffs [D]) of an NOMSD expansion: determinant
    0 the RHF identity (the first na / nb orbitals), determinant d > 0 that
    identity rotated by exp(0.1 K_d), K_d anti-Hermitian with entries of
    variance 1/M (spectral norm ~2 whatever M: a rotation of ~0.2 rad);
    complex coefficients, seeded, normalised."""
    import scipy.linalg

    rng = np.random.default_rng(seed)
    eye = np.eye(m)
    base = np.concatenate([eye[:, :na], eye[:, :nb]], axis=1)
    psi = [base]
    for _ in range(ndets - 1):
        k = (rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))) / (
            np.sqrt(2.0 * m))
        psi.append(scipy.linalg.expm(0.1 * (k - k.conj().T)) @ base)
    c = rng.normal(size=ndets) + 1j * rng.normal(size=ndets)
    return np.stack(psi), c / np.linalg.norm(c)


def spin_flip_psi(psia: np.ndarray, psib: np.ndarray):
    """The 2M x ne GHF embeddings of a UHF pair and of its spin flip
    (up block psib, down block psia; nup = ndown), [2, 2M, ne]."""
    m, na = psia.shape
    nb = psib.shape[1]
    psi = np.zeros((2, 2 * m, na + nb), dtype=complex)
    psi[0, :m, :na], psi[0, m:, na:] = psia, psib
    psi[1, :m, :na], psi[1, m:, na:] = psib, psia
    return psi


def msd_schedule(nsteps: int, nstblz: int, energy_every: int,
                 taylor: bool) -> dict:
    """Launches of a continuous run of ``nsteps`` steps with a
    multi-determinant trial: kernel B 2 at set-up (the walkers' overlaps),
    a step 2 for the per-determinant S^-1 and log-dets of the force bias,
    2 for the new overlaps, 2 per energy (one [w D, n, n] batch a spin
    each time); Cholesky 4 per re-orthogonalisation; the Taylor kernel
    once a step on the Generic path."""
    return {"inv_logdet_lanes": 2 + 4 * nsteps + 2 * (nsteps // energy_every),
            "chol_inv_lanes": 4 * (nsteps // nstblz),
            "taylor_exp": nsteps if taylor else 0}


def ghf_schedule(nsteps: int, nstblz: int, energy_every: int) -> dict:
    """Launches of a discrete run with a GHF trial: kernel B 1 at set-up,
    a step 2 in the kinetic half-steps (log-det), 1 for the sweep's
    S_d^-1, 1 per energy (one [w D, ne, ne] batch each); Cholesky 4 per
    re-orthogonalisation; no sweep kernel (the GHF sweep has none)."""
    return {"inv_logdet_lanes": 1 + 3 * nsteps + nsteps // energy_every,
            "chol_inv_lanes": 4 * (nsteps // nstblz)}


def orthos(n: int, nstblz: int) -> int:
    """Re-orthogonalisations in a back or forward sweep of n slices:
    j = 1 .. n - 1 with j % nstblz == 0."""
    return sum(1 for j in range(1, n) if j % nstblz == 0)


def discrete_schedule(nsteps: int, nstblz: int, energy_every: int,
                      nbp: int, nitcf: int, stable: bool,
                      kernel: bool) -> dict:
    """Launches of a discrete single-site run of ``nsteps`` steps with one
    BP split of ``nbp`` and an ITCF of ``nitcf`` slices sharing the
    buffer: kernel B 2 at set-up, 4 a step in the kinetic half steps, 2
    for the sweep's S^-1, 2 per energy; per BP measurement 2 (gab); per
    ITCF measurement 2 + 4 a slice (stable: equal-time G and the solve;
    unstable: the solve). Cholesky: 4 per forward re-orthogonalisation
    (CholeskyQR2, two spins), 2 per backward or ITCF one (one pass)."""
    nhist = nbp or nitcf
    nbpm = nsteps // nbp if nbp else 0
    nitm = nsteps // nhist if nitcf else 0
    kb = (2 + 6 * nsteps + 2 * (nsteps // energy_every) + 2 * nbpm
          + nitm * (2 + nitcf * (4 if stable else 2)))
    chol = (4 * (nsteps // nstblz) + 2 * orthos(nbp, nstblz) * nbpm
            + nitm * 2 * (orthos(nhist, nstblz)
                          + (orthos(nitcf, nstblz) if stable else 0)))
    return {"inv_logdet_lanes": kb, "chol_inv_lanes": chol,
            "hirsch_sweep": nsteps if kernel else 0}


def golden(path: str, propagator_options: dict | None, make_hubbard,
           trial_from_orbitals, AFQMC, QMCOpts):
    """Equilibrated mean ETotal of the port against the reference series:
    (port mean, reference mean, |diff|, se); raises on a miss."""
    g = np.load(os.path.join(ROOT, "tests", "data", path))
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), device="cuda",
                                dtype="single")
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    rows = AFQMC(ham, trial, qmc, propagator_options=propagator_options,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cuda").run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                        theirs.std(ddof=1) / np.sqrt(len(theirs))))
    diff = float(abs(mine.mean() - theirs.mean()))
    if not (np.isfinite(et).all() and diff < max(4 * se, 0.05)):
        raise AssertionError(f"golden anchor {path} missed: port "
                             f"{mine.mean()} reference {theirs.mean()} "
                             f"se {se}")
    return mine.mean(), theirs.mean(), diff, se


def mesh_continuous(nblocks: int = 2, nwalkers: int = 1024, **afqmc_kw):
    """Phase 4's system as an AFQMC driver on the card (2 blocks of 10
    steps by default)."""
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    qmc = QMCOpts(nwalkers=nwalkers, dt=0.01, nsteps=10, nblocks=nblocks,
                  nstblz=10, npop_control=1, rng_seed=8)
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    return AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cuda", **afqmc_kw)


def mesh_rank(rank: int):
    """One rank of the two-rank run on the card (gloo): phase 4's system,
    this rank's 512 of the 1024 walkers; returns (rows, kernel A's
    launches, block seconds)."""
    sys.path.insert(0, ROOT)
    from pauxy_tpu_torch.ops import greens_cuda
    from pauxy_tpu_torch.parallel import mesh as pmesh

    af = mesh_continuous()
    af.state = pmesh.shard_walkers(af.state, pmesh.walker_mesh(device="cuda"))
    greens_cuda.launches = 0
    rows = af.run()
    torch.cuda.synchronize()
    return rows, greens_cuda.launches, af.block_seconds


def rows_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Largest column-scaled |a - b| of two row blocks (columns 1-9)."""
    a, b = np.asarray(a)[:, 1:10].real, np.asarray(b)[:, 1:10].real
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a).max(0),
                                                    1e-30)))


# The kernels that count their launches by route, and the routes.
ROUTES = {"taylor_bf16": ("resident", "streaming"),
          "gemm_bf16x3": ("tile", "narrow", "skinny")}


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from pauxy_tpu_torch.ops import (batchla_cuda, cpqr_cuda, exx_cuda,
                                     gemm3_cuda, greens_cuda,
                                     pw_force_bias_cuda, sweep_cuda,
                                     taylor_cuda)

    return {"greens_lanes": greens_cuda.launches,
            "inv_logdet_lanes": batchla_cuda.launches,
            "chol_inv_lanes": batchla_cuda.chol_launches,
            "hirsch_sweep": sweep_cuda.launches,
            "taylor_exp": taylor_cuda.launches,
            "taylor_bf16": taylor_cuda.launches_bf16,
            "taylor_bf16_resident": taylor_cuda.launches_bf16_resident,
            "taylor_bf16_streaming": taylor_cuda.launches_bf16_streaming,
            "exx": exx_cuda.launches,
            "cpqr": cpqr_cuda.launches,
            "gemm_bf16x3": gemm3_cuda.launches,
            **{f"gemm_bf16x3_{r}": n
               for r, n in gemm3_cuda.launches_by_route.items()},
            "pw_force_bias": pw_force_bias_cuda.launches}


def zero_kernel_counts() -> None:
    from pauxy_tpu_torch.ops import (batchla_cuda, cpqr_cuda, exx_cuda,
                                     gemm3_cuda, greens_cuda,
                                     pw_force_bias_cuda, sweep_cuda,
                                     taylor_cuda)

    greens_cuda.launches = 0
    batchla_cuda.launches = 0
    batchla_cuda.chol_launches = 0
    sweep_cuda.launches = 0
    taylor_cuda.launches = 0
    taylor_cuda.launches_bf16 = 0
    taylor_cuda.launches_bf16_resident = 0
    taylor_cuda.launches_bf16_streaming = 0
    exx_cuda.launches = 0
    cpqr_cuda.launches = 0
    gemm3_cuda.launches = 0
    for r in gemm3_cuda.launches_by_route:
        gemm3_cuda.launches_by_route[r] = 0
    pw_force_bias_cuda.launches = 0


# Phase 34's runs on a [walker 1, chol 2] mesh: (a) back propagation with
# energies and EKT at the Generic bench shape, (b) the ITCF on the golden
# system, (c) the stochastic-RI energy and the sketched step at the bench
# shape, (d) the thermal Generic path at phase 19's shape.
CHOL_RUNS = ("bp", "itcf", "sri", "sri_step", "thermal")
# The kernels whose launches a chol rank shares with the unsharded run
# (each chol rank propagates every walker).
CHOL_SAME = ("chol_inv_lanes", "taylor_exp", "inv_logdet_lanes", "cpqr")
# The bench-shape Hamiltonian and RHF trial, built once a process.
_BENCH = {}


def chol_driver(name: str):
    """One of ``CHOL_RUNS`` as an unsharded driver on the card, complex64:
    "bp" phase 16's bench-shape run (nmo=128, naux=512, (16, 16), 1024
    walkers, dt=0.005, one block of 10 steps, taylor_impl="pallas") with
    one BP measurement of tau_bp=0.05 with energies and EKT; "itcf" the
    golden generic_nmo11.npz system (its 65 Cholesky vectors and a zero
    one, so that X splits in two), 16 walkers, dt=0.01, the ITCF of
    tau_max=0.1, stable; "sri" and "sri_step" phase 30's stochastic-RI
    energy (20 probes) and sketched step (S = 2048) at the bench shape;
    "thermal" phase 19's Generic thermal path (64 walkers, beta=0.5,
    dt=0.05, one path). Population control is off (npop_control past the
    run), so that a comb pick at a float32 boundary cannot swap walkers
    between two runs that differ by rounding; on [walker 1, chol 2] it
    moves nothing between ranks anyway."""
    sys.path.insert(0, ROOT)
    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    card = dict(device="cuda", dtype="single")
    mixed = {"mixed": {"energy_eval_freq": 1}}
    pallas = {"taylor_impl": "pallas"}
    if name == "itcf":
        g = np.load(os.path.join(ROOT, "tests", "data", "generic_nmo11.npz"))
        n = g["h1e"].shape[-1]
        chol = np.asarray(g["chol"]).reshape(-1, n, n).transpose(1, 2, 0)
        chol = np.concatenate([chol, np.zeros((n, n, 1))], axis=-1)
        ham = make_generic((3, 3), np.stack([g["h1e"], g["h1e"]]), chol,
                           ecore=float(g["enuc"]), **card)
        qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=1, nstblz=5,
                      npop_control=20, rng_seed=8)
        return AFQMC(ham, rhf_identity_trial(ham, **card), qmc,
                     propagator_options=pallas,
                     estimator_options={**mixed, "itcf": {
                         "tau_max": 0.1, "stable": True}}, device="cuda")
    if not _BENCH:
        _BENCH["ham"] = generic_model(128, 512, 16, make_generic)
        _BENCH["trial"] = rhf_identity_trial(_BENCH["ham"], **card)
    ham, trial = _BENCH["ham"], _BENCH["trial"]
    if name == "sri":
        # The stochastic-RI system differs from the plain one in its flags
        # only; without the control variate its trial is the same.
        ham = copy.copy(ham)
        ham.stochastic_ri, ham.nsamples = True, 20
    if name == "thermal":
        trial = make_one_body_trial(ham, 0.5, 0.05, **card)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=64, dt=0.05, nsteps=1, nblocks=1, beta=0.5,
            npop_control=100, rng_seed=8), device="cuda")
    popts = dict(pallas)
    if name == "sri_step":
        popts.update(stochastic_ri=True, nsamples=2048)
    eopts = dict(mixed)
    if name == "bp":
        eopts["back_propagation"] = {"tau_bp": 0.05, "evaluate_energy": True,
                                     "evaluate_ekt": True}
    qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=1, nstblz=5,
                  npop_control=20, rng_seed=8)
    return AFQMC(ham, trial, qmc, propagator_options=popts,
                 estimator_options=eopts, device="cuda")


def chol_runs(mesh=None) -> dict:
    """Every run of ``CHOL_RUNS``, unsharded or, with ``mesh``, through
    shard_generic and shard_walkers: {name: (rows, the BP row or the
    ITCF's G, launches, seconds)}, the launches counted from 0 before the
    driver is built."""
    from pauxy_tpu_torch.parallel import mesh as pmesh

    out = {}
    for name in CHOL_RUNS:
        zero_kernel_counts()
        af = chol_driver(name)
        if mesh is not None:
            af.ham, af.trial, af.prop = pmesh.shard_generic(
                af.ham, af.trial, af.prop, mesh)
            af.state = pmesh.shard_walkers(af.state, mesh)
        t0 = time.perf_counter()
        try:
            rows = af.run()
            torch.cuda.synchronize()
        finally:
            pmesh.set_active_mesh(None)
        seconds = time.perf_counter() - t0
        extra = {}
        if name == "bp":
            extra = {k: np.asarray(v)
                     for k, v in af.bp_reporter.rows[0].items()}
        elif name == "itcf":
            extra = {"G": np.asarray(
                af.itcf_reporter.rows[0]["real_space_greens_function"])}
        out[name] = (np.asarray(rows), extra, kernel_counts(), seconds)
        del af
        torch.cuda.empty_cache()
    _BENCH.clear()
    return out


def chol_rank(rank: int):
    """One rank of phase 34's [walker 1, chol 2] mesh on cuda:0 (gloo)."""
    sys.path.insert(0, ROOT)
    from pauxy_tpu_torch.parallel import mesh as pmesh

    return chol_runs(pmesh.walker_chol_mesh(2, device="cuda"))


def chol_rel(name: str, ref, got) -> float:
    """Largest difference of a chol-mesh run from the unsharded one:
    column-scaled over the rows (columns 1-9; a thermal row's 1-10), each
    BP or ITCF array scaled by its largest entry. EHybrid (column 8) is
    scaled by the larger of its own and ETotal's (column 5): at finite
    temperature it is a difference of log-determinants over dt, two orders
    below ETotal, whose float32 rounding (1e-3 of the column at a tiny
    thermal Generic system, the same in the unsharded run against
    complex128) no partial sum adds to."""
    a, b = ref[0].real, got[0].real
    scale = np.maximum(np.abs(a).max(0), 1e-30)
    scale[8] = max(scale[8], scale[5])
    cols = slice(1, 11) if name == "thermal" else slice(1, 10)
    rel = [float(np.max((np.abs(a - b) / scale)[:, cols]))]
    for k, x in ref[1].items():
        y = got[1][k]
        rel.append(float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30)))
    return max(rel)


def chol_phase(ref: dict, ranks: list) -> tuple[str, dict]:
    """Holds the two chol ranks' runs against the unsharded ones: rows and
    the BP / ITCF arrays within 1e-5 relative, the two ranks' rows equal,
    each rank's launches of ``CHOL_SAME`` equal to the unsharded run's,
    and the exchange kernel launched in (a)'s mixed energy (the unsharded
    run takes the supermatrix). Returns (the line, rank 0's launches by
    run)."""
    parts = []
    for name in CHOL_RUNS:
        r = ref[name]
        rel = [chol_rel(name, r, g[name]) for g in ranks]
        same_rows = all(np.array_equal(ranks[0][name][0][:, :-1],
                                       g[name][0][:, :-1]) for g in ranks)
        bad = [k for k in CHOL_SAME for g in ranks
               if g[name][2][k] != r[2][k]]
        exx = [g[name][2]["exx"] for g in ranks]
        if max(rel) > 1e-5 or not same_rows or bad or (
                name == "bp" and min(exx) == 0):
            raise AssertionError(
                f"chol mesh {name}: relative {rel}, ranks' rows equal "
                f"{same_rows}, launches per rank "
                f"{[g[name][2] for g in ranks]} vs unsharded {r[2]}")
        launches = "; ".join(
            f"{k} {[g[name][2][k] for g in ranks]} vs {r[2][k]}"
            for k in CHOL_SAME + ("exx",))
        parts.append(
            f"({name}) within {max(rel):.2e} relative, launches per rank vs "
            f"unsharded: {launches}; seconds unsharded {r[3]:.3f}, per rank "
            f"{[round(g[name][3], 3) for g in ranks]}")
    return "; ".join(parts), {name: ranks[0][name][2] for name in CHOL_RUNS}


def mesh_phase(counts, zero_counts):
    """Phase 34: the walker mesh on the card (see the module docstring).
    Returns (the phase line, the sharded continuous and Generic runs'
    launch counts, and rank 0's of each chol-mesh run)."""
    import contextlib
    import io

    import torch.distributed as dist

    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.parallel import launch
    from pauxy_tpu_torch.parallel import mesh as pmesh
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.utils.checkpoint import (load_walkers_sharded,
                                                  save_walkers_sharded)

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
        rank=0, world_size=1)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh = pmesh.walker_mesh()
        zero_counts()
        af = mesh_continuous()
        ref = af.run()
        torch.cuda.synchronize()
        ref_counts = counts()
        ref_s = af.block_seconds
        zero_counts()
        af = mesh_continuous()
        af.state = pmesh.shard_walkers(af.state, mesh)
        rows = af.run()
        torch.cuda.synchronize()
        mesh_cont = counts()
        mesh_s = af.block_seconds
        rel_cont = rows_rel(ref, rows)
        if rel_cont > 1e-6 or mesh_cont != ref_counts:
            raise AssertionError(
                f"mesh continuous: rows rel {rel_cont:.2e}, launches "
                f"{mesh_cont} vs {ref_counts}")
        ckpt = os.path.join(work, "ckpt")
        save_walkers_sharded(af.state, ckpt, generator=af.generator,
                             step=af.step, eshift=af.eshift)
        back, info = load_walkers_sharded(mesh_continuous().state, ckpt,
                                          mesh=mesh)
        for name in ("phia", "phib", "weight", "log_ovlp"):
            if not torch.equal(getattr(back, name), getattr(af.state, name)):
                raise AssertionError(f"sharded checkpoint: {name} differs")
        if info["step"] != af.step or info["rng_state"] is None:
            raise AssertionError(f"sharded checkpoint info {info}")
        mq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2,
                     nstblz=5, npop_control=1, rng_seed=8)
        gham = generic_model(128, 512, 16, make_generic)
        gtrial = rhf_identity_trial(gham, device="cuda", dtype="single")
        gkw = dict(propagator_options={"taylor_impl": "pallas"},
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   device="cuda")
        zero_counts()
        gref = AFQMC(gham, gtrial, mq, **gkw).run()
        torch.cuda.synchronize()
        gref_counts = counts()
        zero_counts()
        af = AFQMC(gham, gtrial, mq, **gkw)
        af.ham, af.trial, af.prop = pmesh.shard_generic(af.ham, af.trial,
                                                        af.prop, mesh)
        af.state = pmesh.shard_walkers(af.state, mesh)
        grows = af.run()
        torch.cuda.synchronize()
        mesh_gen = counts()
        rel_gen = rows_rel(gref, grows)
        if rel_gen > 1e-6 or mesh_gen != gref_counts:
            raise AssertionError(
                f"mesh Generic: rows rel {rel_gen:.2e}, launches "
                f"{mesh_gen} vs {gref_counts}")
        del gham, gtrial, af
        prof_dir = os.path.join(work, "trace")
        mesh_continuous(nblocks=1, profile_dir=prof_dir).run()
        traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
        trace_bytes = sum(os.path.getsize(f) for f in traces)
        if len(traces) != 1 or trace_bytes == 0:
            raise AssertionError(f"profile_dir trace: {traces}")
        af = mesh_continuous(nblocks=3, block_mode="split", verbose=True)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            af.run()
        table = [line for line in out.getvalue().splitlines()
                 if line.startswith("# - ")]
        want_lines = ("# - Setup:", "# - Orthogonalisation:",
                      "# - Propagation:", "# - Population control:",
                      "# - Estimators:")
        phase_sum = sum(af.timing[k] for k in ("ortho", "prop", "pop",
                                               "estim"))
        share = phase_sum / af.timing["block"]
        if len(table) != len(want_lines) or not all(
                line.startswith(w) for line, w in zip(table, want_lines)) \
                or abs(share - 1) > 0.1:
            raise AssertionError(f"split table {table}, phases / block "
                                 f"{share:.3f}")
    finally:
        pmesh.set_active_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    try:
        two = launch.run_ranks(mesh_rank, 2, backend="gloo", timeout=300)
        two_ok = True
    except RuntimeError as exc:
        # Only gloo's refusal of a collective on CUDA tensors is a finding;
        # anything else is a failure of the port.
        text = str(exc)
        if "gloo" not in text.lower() or not any(
                k in text for k in ("not supported", "unsupported",
                                    "No backend type associated",
                                    "only supports CPU", "CPU tensors")):
            raise
        two_ok = False
        two_note = text.strip().splitlines()[-1][:300]
    if two_ok:
        # Every column but the wall-clock Time.
        if any(not np.array_equal(two[0][0][:, :10], r[:, :10])
               for r, _, _ in two[1:]):
            raise AssertionError("two ranks report different rows")
        rel_two = rows_rel(ref, two[0][0])
        if rel_two > 1e-5:
            raise AssertionError(f"two ranks on one card: rows rel "
                                 f"{rel_two:.2e} vs the one-rank run")
        two_msg = (f"two ranks on cuda:0 over gloo (512 walkers each): rows "
                   f"within {rel_two:.2e} relative of the one-rank run, "
                   f"kernel A launches per rank {[c for _, c, _ in two]}, "
                   f"block seconds per rank "
                   f"{[[round(t, 4) for t in s] for _, _, s in two]}")
    else:
        two_msg = ("two ranks on cuda:0 over gloo: gloo refuses a "
                   f"collective on CUDA tensors ({two_note}); the two-rank "
                   "run is held by the CPU tests only")
    # The chol axis: the unsharded runs here, then two gloo ranks sharing
    # cuda:0 as a [walker 1, chol 2] mesh (NCCL puts one rank on a card).
    chol_ref = chol_runs()
    chol_ranks = launch.run_ranks(chol_rank, 2, backend="gloo", timeout=600)
    chol_msg, mesh_chol = chol_phase(chol_ref, chol_ranks)
    msg = (f"one-rank NCCL group: continuous 1024 walkers rows within "
           f"{rel_cont:.2e} relative of the unsharded run, launches "
           f"{mesh_cont}, block seconds unsharded "
           f"{[round(t, 4) for t in ref_s]}, through the mesh "
           f"{[round(t, 4) for t in mesh_s]}; Generic bench shape rows within {rel_gen:.2e}, "
           f"launches {mesh_gen}; sharded checkpoint round trip exact; "
           f"profile trace {trace_bytes} bytes; split table {table}, phases "
           f"/ block wall {share:.3f}; {two_msg}; two gloo ranks on cuda:0 "
           f"as a [walker 1, chol 2] mesh against the unsharded runs: "
           f"{chol_msg}")
    return msg, mesh_cont, mesh_gen, mesh_chol


# The matmul-precision ladder (phase 35): the JAX package's tiers in the
# order of the port's config.MATMUL_TIERS, float32 first.
LADDER = ("float32", "bfloat16_3x", "bfloat16")
# Card (complex64) against host (complex128) with the same injected draws,
# max |d| over the scale, per path and tier. The float32 tier keeps phases
# 4/10/12/22's limits. A lower tier with a relative error e a product
# (phase 35 (a) at the Generic VHS shape), over N tier-taking products
# chained between the draws and a block's sums with independent roundings,
# gives about e sqrt(N): the continuous Hubbard cell ~6 a step x 20 steps
# (N = 120); the Generic golden ~12 a step (VHS, six Taylor products, force
# bias, G, CholeskyQR2) x 100 steps (1200); the UEG ~10 x 20 (200); the
# thermal Hubbard ~12 a slice x 10 slices a path (120); the PHMSD energy ~8
# products and no chain (8; every walker's energy is E_FCI). "bfloat16" is
# cuBLAS's TF32 on the H100 (torch 2.11: fp32_precision "tf32"),
# e = 2.84e-4: 3e-3, 1e-2, 4e-3, 3e-3, 1e-3. "bfloat16_3x" is the 3-pass
# split GEMM, e3 = 5.615e-6 (the larger of (a)'s real and complex64
# readings on an H100 80GB HBM3 at 700 W before (c) first ran): e3 sqrt(N)
# rounded up to two digits. Written in PERF.md section 2 before the first
# run of (c).
LADDER_BOUNDS = {
    "hubbard": {"float32": 1e-4, "bfloat16_3x": 6.2e-5, "bfloat16": 3e-3},
    "generic": {"float32": 2e-4, "bfloat16_3x": 2.0e-4, "bfloat16": 1e-2},
    "ueg": {"float32": 1e-4, "bfloat16_3x": 8.0e-5, "bfloat16": 4e-3},
    "thermal": {"float32": 1e-4, "bfloat16_3x": 6.2e-5, "bfloat16": 3e-3},
    "phmsd": {"float32": 1e-4, "bfloat16_3x": 1.6e-5, "bfloat16": 1e-3},
}
# The split tier's product error at the Generic VHS shape, real and
# complex64 (JAX's 'bfloat16_3x' reads ~3e-5 on the TPU).
SPLIT_PRODUCT_BOUND = 3e-5
# A float32 / complex64 GEMM of cuBLAS or CUTLASS by its kernel's name
# (the 64-bit ones, and the split GEMM itself, aside).
GEMM_32 = re.compile(r"cf32|f32|tf32|sgemm|cgemm|[sc]\d{3,4}gemm|<float",
                     re.IGNORECASE)
GEMM_64 = re.compile(r"f64|dgemm|zgemm|[dz]\d{3,4}gemm|<double",
                     re.IGNORECASE)


def rung_in_force() -> str:
    """Torch's float32-product setting as this torch reports it: the rung,
    cuBLAS's side of it and whether the split route is installed."""
    from pauxy_tpu_torch.ops import gemm3_cuda

    cm = torch.backends.cuda.matmul
    fp = getattr(cm, "fp32_precision", None)
    side = (f"cuda.matmul.fp32_precision={fp}" if fp is not None
            else f"cuda.matmul.allow_tf32={cm.allow_tf32}")
    route = ", split route" if gemm3_cuda.route_installed() else ""
    return f"{torch.get_float32_matmul_precision()}, {side}{route}"


def vhs_operands(gen, w: int = 1024, x: int = 512, mm: int = 128 * 128):
    """A real and a complex pair at the Generic VHS shape [w, X] x [X, M^2]
    (1024 walkers, X = 512, M = 128)."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    a, b = randn(w, x), randn(x, mm) / x ** 0.5
    return (a, b), (torch.complex(a, randn(w, x)),
                    torch.complex(b, randn(x, mm) / x ** 0.5))


def product_errors() -> dict:
    """Phase 35 (a): per ladder tier, the relative error max|C - C_64| /
    max|C_64| of a real float32 and of a complex64 product ``a @ b`` at the
    Generic VHS shape against the float64 product of the same operands,
    each product's median ms, the torch setting in force and the split
    GEMM's launches."""
    from pauxy_tpu_torch import config
    from pauxy_tpu_torch.ops import gemm3_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(35)
    (a, b), (ac, bc) = vhs_operands(gen)
    ref = a.double() @ b.double()
    refc = ac.to(torch.complex128) @ bc.to(torch.complex128)

    def rel(c, r):
        return float((c.to(r.dtype) - r).abs().max() / r.abs().max())

    out = {}
    for tier in LADDER:
        config.set_matmul_precision(tier, "cuda")
        gemm3_cuda.launches = 0
        errs = (rel(a @ b, ref), rel(ac @ bc, refc))
        torch.cuda.synchronize()
        launched = gemm3_cuda.launches
        t = median_ms({"real": lambda: a @ b, "complex": lambda: ac @ bc},
                      reps=10)
        out[tier] = {"setting": rung_in_force(), "real": errs[0],
                     "complex": errs[1], "real_ms": t["real"],
                     "complex_ms": t["complex"], "launches": launched}
    config.set_matmul_precision("float32", "cuda")
    if out["bfloat16_3x"]["launches"] != 2 or any(
            out[t]["launches"] for t in ("float32", "bfloat16")):
        raise AssertionError(f"(a): split GEMM launches per tier "
                             f"{ {t: p['launches'] for t, p in out.items()} }"
                             f", want 2 under bfloat16_3x only")
    split = out["bfloat16_3x"]
    if not max(split["real"], split["complex"]) <= SPLIT_PRODUCT_BOUND:
        raise AssertionError(f"(a): bfloat16_3x product error "
                             f"{split['real']:.3e} / {split['complex']:.3e} "
                             f"over {SPLIT_PRODUCT_BOUND:g}")
    return out


def gemm3_work(m: int, k: int, n: int, batch: int = 1, cplx: bool = False):
    """(bytes, FLOPs) of the split GEMM: A, B read once and D written once;
    3 passes of 2 m n k a real product, four real products a complex one."""
    item = 8 if cplx else 4
    nbytes = batch * (m * k + k * n + m * n) * item
    return nbytes, batch * (4 if cplx else 1) * 3 * 2 * m * n * k


def gemm3_tolerance(a, b, k: int, alpha=1.0, beta=0.0, c=None):
    """The bound the kernel is held to against its plain version,
    elementwise: 12 k eps S + 4 eps |beta| |C|, eps = 2^-23,
    S = |alpha| (|Ar| + |Ai|) (|Br| + |Bi|) (every product term's size).
    Both sum the same exact bf16 products (at most 6 k of them in an
    element of a complex product) in float32: the plain version's cuBLAS
    rounding to nearest (<= eps / 2 of the running sum an add), the tensor
    cores possibly truncating (<= eps); 9 k eps S in all, held to 12 k eps
    S; alpha, beta and their sum add a few eps."""
    eps = 2.0 ** -23

    def mag(x):
        x = x.resolve_conj()
        m = x.real.abs() + x.imag.abs() if x.is_complex() else x.abs()
        return m.double()

    tol = 12 * k * eps * abs(alpha) * torch.matmul(mag(a), mag(b))
    if c is not None and beta != 0:
        tol = tol + 4 * eps * abs(beta) * mag(c)
    return tol


def gemm3_cases(gen, dtype) -> list:
    """(a')'s cases: (name, kernel call, plain call, k, alpha, beta, c, a, b)
    over the shapes the paths give and the layouts einsum hands over."""
    from pauxy_tpu_torch.ops import gemm3, gemm3_cuda

    def rnd(*shape):
        return torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)

    cases = []
    for m, k, n in ((7, 16, 7), (93, 93, 93), (257, 14, 257), (1, 33, 1),
                    (5, 0, 3), (1024, 512, 16384)):
        a, b = rnd(m, k), rnd(k, n)
        cases.append((f"mm ({m},{k},{n})", gemm3_cuda.mm, gemm3.mm, k, 1.0,
                      0.0, None, a, b))
    a, b = rnd(3, 93, 16), rnd(16, 7).expand(3, 16, 7)
    cases.append(("bmm batch 3, broadcast B", gemm3_cuda.bmm, gemm3.bmm, 16,
                  1.0, 0.0, None, a, b))
    a, b = rnd(70000, 2, 3), rnd(70000, 3, 2)
    cases.append(("bmm batch 70000", gemm3_cuda.bmm,
                  gemm3.bmm, 3, 1.0, 0.0, None, a, b))
    at, bt = rnd(14, 257), rnd(257, 14)
    a, b = at.T, bt.T
    if dtype.is_complex:
        a = a.conj()
    cases.append(("mm transposed (257,14,257)" + (", A conjugated"
                                                   if dtype.is_complex
                                                   else ""),
                  gemm3_cuda.mm, gemm3.mm, 14, 1.0, 0.0, None, a, b))
    p = rnd(64, 3, 48).permute(1, 0, 2)
    q = rnd(32, 3, 48).permute(1, 2, 0)
    cases.append(("bmm permuted [3, 64, 48] x [3, 48, 32]", gemm3_cuda.bmm,
                  gemm3.bmm, 48, 1.0, 0.0, None, p, q))
    flat = rnd(93 * 93 + 1)
    a = flat[1:].view(93, 93)
    cases.append(("mm unaligned (93,93,93)", gemm3_cuda.mm, gemm3.mm, 93,
                  1.0, 0.0, None, a, rnd(93, 93)))
    alpha, beta = (2.0, 0.5) if not dtype.is_complex else (0.5 - 2j,
                                                          1.25 + 0.5j)
    c = rnd(93)
    cases.append(("addmm (93,14,93), bias broadcast",
                  lambda x, y: gemm3_cuda.addmm(c, x, y, beta=beta,
                                                alpha=alpha),
                  lambda x, y: gemm3.addmm(c, x, y, beta=beta, alpha=alpha),
                  14, alpha, beta, c.expand(93, 93), rnd(93, 14),
                  rnd(14, 93)))
    # The skinny route: the thermal force bias's batched dot products, the
    # UEG's permuted vector-matrix products, a small N (transposed) with B
    # conjugated, addmm with five rows.
    cases.append(("bmm batched dot [300, 1, 8649] x [300, 8649, 1]",
                  gemm3_cuda.bmm, gemm3.bmm, 8649, 1.0, 0.0, None,
                  rnd(300, 1, 8649), rnd(300, 8649, 1)))
    cases.append(("bmm permuted [493, 1, 7] x [493, 7, 512]",
                  gemm3_cuda.bmm, gemm3.bmm, 7, 1.0, 0.0, None,
                  rnd(7, 1, 493).permute(2, 1, 0),
                  rnd(512, 7, 493).permute(2, 1, 0)))
    b7 = rnd(257, 7)
    cases.append(("mm (257,257,7)" + (", B conjugated" if dtype.is_complex
                                      else ""),
                  gemm3_cuda.mm, gemm3.mm, 257, 1.0, 0.0, None,
                  rnd(257, 257), b7.conj() if dtype.is_complex else b7))
    cases.append(("addmm (5,14,93), bias broadcast",
                  lambda x, y: gemm3_cuda.addmm(c, x, y, beta=beta,
                                                alpha=alpha),
                  lambda x, y: gemm3.addmm(c, x, y, beta=beta, alpha=alpha),
                  14, alpha, beta, c.expand(5, 93), rnd(5, 14),
                  rnd(14, 93)))
    cb = rnd(3, 7, 7)
    cases.append(("baddbmm (3,7,16,7)",
                  lambda x, y: gemm3_cuda.baddbmm(cb, x, y, beta=-1.5,
                                                  alpha=0.75),
                  lambda x, y: gemm3.baddbmm(cb, x, y, beta=-1.5,
                                             alpha=0.75),
                  16, 0.75, -1.5, cb, rnd(3, 7, 16), rnd(3, 16, 7)))
    # The wgmma tiles: ragged edges of the 128-row tile; the narrow tile
    # (the "xla" Taylor product among them); one product with A in four
    # layouts: contiguous (TMA), rows of 97 elements (TMA over groups of
    # rows), a base 4 bytes past 16 (a bulk copy a row) and columns at
    # stride 3 (an element a copy); conjugated, broadcast and beta C on the
    # tile routes.
    for m, k, n in ((1000, 300, 16383), (129, 17, 130), (200, 64, 14),
                    (300, 64, 30)):
        cases.append((f"mm ({m},{k},{n})", gemm3_cuda.mm, gemm3.mm, k, 1.0,
                      0.0, None, rnd(m, k), rnd(k, n)))
    cases.append(("bmm [512,257,257]x[512,257,14]", gemm3_cuda.bmm,
                  gemm3.bmm, 257, 1.0, 0.0, None, rnd(512, 257, 257),
                  rnd(512, 257, 14)))
    x, y = rnd(96, 96), rnd(96, 96)
    rows97 = torch.zeros(96, 97, dtype=dtype, device="cuda")
    rows97[:, :96] = x
    past16 = torch.zeros(96 * 96 + 1, dtype=dtype, device="cuda")
    past16[1:] = x.reshape(-1)
    cols3 = torch.zeros(96, 288, dtype=dtype, device="cuda")
    cols3[:, ::3] = x
    for label, a in (("TMA", x), ("rows of 97, TMA over groups of rows",
                                  rows97[:, :96]),
                     ("base 4 bytes past 16, a bulk copy a row",
                      past16[1:].view(96, 96)),
                     ("columns at stride 3, an element a copy",
                      cols3[:, ::3])):
        cases.append((f"mm (96,96,96), {label}", gemm3_cuda.mm, gemm3.mm, 96,
                      1.0, 0.0, None, a, y))
    ab = rnd(1, 128, 128).expand(6, 128, 128)
    cases.append(("bmm broadcast A [6,128,128]x[6,128,16]" + (
        ", B conjugated" if dtype.is_complex else ""), gemm3_cuda.bmm,
                  gemm3.bmm, 128, 1.0, 0.0, None, ab,
                  rnd(6, 128, 16).conj() if dtype.is_complex
                  else rnd(6, 128, 16)))
    cc = rnd(4, 200, 150)
    cases.append(("baddbmm (4,200,64,150)",
                  lambda x, y: gemm3_cuda.baddbmm(cc, x, y, beta=beta,
                                                  alpha=alpha),
                  lambda x, y: gemm3.baddbmm(cc, x, y, beta=beta,
                                             alpha=alpha),
                  64, alpha, beta, cc, rnd(4, 200, 64).conj()
                  if dtype.is_complex else rnd(4, 200, 64),
                  rnd(4, 64, 150)))
    if not dtype.is_complex:
        # float32 views at stride 2 (a complex tensor's planes), staged
        # through their complex pairs, as A and as B (transposed: K-major).
        c64 = torch.complex64

        def crnd(*shape):
            return torch.randn(*shape, dtype=c64, device="cuda",
                               generator=gen)

        cases.append(("mm A .real of c64 [1024,512] x [512,16384]",
                      gemm3_cuda.mm, gemm3.mm, 512, 1.0, 0.0, None,
                      crnd(1024, 512).real, rnd(512, 16384)))
        cases.append(("mm [1024,512] x B .imag of c64 [16384,512]^T",
                      gemm3_cuda.mm, gemm3.mm, 512, 1.0, 0.0, None,
                      rnd(1024, 512), crnd(16384, 512).imag.T))
        cases.append(("mm A .imag of c64 [200,64] x [64,300]", gemm3_cuda.mm,
                      gemm3.mm, 64, 1.0, 0.0, None, crnd(200, 64).imag,
                      rnd(64, 300)))
        cases.append(("bmm A .real of c64 [3,130,40]^T x B .imag of c64 "
                      "[3,130,20]", gemm3_cuda.bmm, gemm3.bmm, 130, 1.0, 0.0,
                      None, crnd(3, 130, 40).real.transpose(1, 2),
                      crnd(3, 130, 20).imag))
    return cases


def check_gemm3(gen) -> tuple[float, str, dict]:
    """Phase 35 (a'): the split GEMM against its plain version on the card
    (float32 and complex64; ``gemm3_cases``), elementwise within
    ``gemm3_tolerance``, each case launched on the route ``plan`` picks for
    it and every route taken in both types. Returns the largest
    |kernel - plain| at the Generic VHS shape (float32), the readings
    (largest |d| / bound per type) and the launches by type and route."""
    from pauxy_tpu_torch.ops import gemm3_cuda

    main_err, worst, taken = None, {}, {}
    for dtype in (torch.float32, torch.complex64):
        worst[dtype] = (0.0, "")
        by_route = taken[str(dtype).split(".")[-1]] = dict.fromkeys(
            gemm3_cuda.launches_by_route, 0)
        for name, kern, plain, k, alpha, beta, c, a, b in gemm3_cases(gen,
                                                                       dtype):
            route = gemm3_cuda.plan(a, b).route
            before = dict(gemm3_cuda.launches_by_route)
            got, want = kern(a, b), plain(a, b)
            torch.cuda.synchronize()
            delta = {r: gemm3_cuda.launches_by_route[r] - before[r]
                     for r in before}
            if got.numel() and (delta[route] < 1 or sum(delta.values())
                                != delta[route]):
                raise AssertionError(f"gemm_bf16x3 {dtype} {name}: launches "
                                     f"by route {delta}, want {route}")
            for r, n in delta.items():
                by_route[r] += n
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"gemm_bf16x3 {dtype} {name}: shape "
                                     f"{tuple(got.shape)} or not finite")
            d = (got - want).abs().double()
            tol = gemm3_tolerance(a, b, k, alpha, beta, c)
            if not bool((d <= tol).all()):
                raise AssertionError(
                    f"gemm_bf16x3 {dtype} {name}: max |d| / bound "
                    f"{float((d / tol).max()):.3g}")
            ratio = float((d / tol.clamp_min(1e-300)).max())
            if ratio >= worst[dtype][0]:
                worst[dtype] = (ratio, name)
            if dtype == torch.float32 and name == "mm (1024,512,16384)":
                main_err = float(d.max())
            del got, want, d, tol
    missing = [(t, r) for t, rs in taken.items() for r, n in rs.items()
               if n == 0]
    if missing:
        raise AssertionError(f"gemm_bf16x3: routes never taken {missing}: "
                             f"{taken}")
    return main_err, "; ".join(
        f"{str(t).split('.')[-1]} {r:.3e} ({n})" for t, (r, n) in
        worst.items()), taken


def gemm3_times(gen) -> tuple[dict, tuple, list]:
    """The split GEMM's median ms at the Generic VHS shape (the wrapper;
    the kernel's device time, by the profiler and by CUDA events over
    queued launches; the plain version; cuBLAS's IEEE float32
    product as the library call and its TF32 mode), its bound, and the
    same as ``at_shape`` rows: at the VHS shape in complex64 and with A
    the real plane of a complex64 [1024, 512] (the Generic block's
    products), the "xla" Taylor product [512, 257, 257] x [512, 257, 14]
    complex64 (the narrow tile), and a lattice shape (phase 4's
    propagator applied to every walker: [16, 16] x [16, 7 x 1024]
    complex64)."""
    from pauxy_tpu_torch import config
    from pauxy_tpu_torch.ops import gemm3, gemm3_cuda

    (a, b), (ac, bc) = vhs_operands(gen)

    def crnd(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                           generator=gen)

    lat = crnd(16, 16), crnd(16, 7 * 1024)
    taylor = crnd(512, 257, 257), crnd(512, 257, 14)

    def timed(x, y, reps=10):
        t = median_ms({"kernel": lambda: gemm3_cuda.mm(x, y),
                       "plain": lambda: gemm3.mm(x, y),
                       "library": lambda: x @ y}, reps=reps)
        config.set_matmul_precision("bfloat16", "cuda")
        t["tf32"] = median_ms({"tf32": lambda: x @ y}, reps=reps)["tf32"]
        config.set_matmul_precision("float32", "cuda")
        t["device"] = device_ms(lambda: gemm3_cuda.mm(x, y), "gemm_bf16x3")
        # The same by CUDA events over launches queued behind a sleep, a
        # check on the profiler's figure.
        t["queued"] = queued_ms(lambda: gemm3_cuda.mm(x, y))
        return t

    main = timed(a, b)
    rows = []
    for shape, (x, y), wk in (
            ("[1024,512]x[512,16384] c64 (the Generic VHS build)", (ac, bc),
             gemm3_work(1024, 512, 16384, cplx=True)),
            ("[1024,512]x[512,16384] f32, A the real plane of a c64 tensor",
             (ac.real, b), gemm3_work(1024, 512, 16384)),
            ("[512,257,257]x[512,257,14] c64 (the \"xla\" Taylor product)",
             taylor, gemm3_work(257, 257, 14, batch=512, cplx=True)),
            ("[16,16]x[16,7168] c64 (a lattice shape)", lat,
             gemm3_work(16, 16, 7168, cplx=True))):
        t = timed(x, y)
        bnd = bound_ms(*wk, torch.bfloat16)
        rows.append({"shape": shape, "ms": t["kernel"],
                     "device_ms": t["device"], "queued_ms": t["queued"],
                     "plain_ms": t["plain"],
                     "library_ms": t["library"], "tf32_ms": t["tf32"],
                     "bound_ms": bnd[0], "bound_by": bnd[1]})
    return main, bound_ms(*gemm3_work(1024, 512, 16384), torch.bfloat16), rows


def library_gemms(names) -> tuple[dict, int]:
    """Of a profile's CUDA kernel names: the float32 / complex64 GEMMs of
    cuBLAS or CUTLASS (name -> launches; names holding "gemm" with a
    32-bit type and no 64-bit one, the split GEMM aside), and how many
    other GEMM launches there were."""
    found, other = {}, 0
    for name in names:
        if "gemm" not in name.lower() or "bf16x3" in name:
            continue
        if GEMM_32.search(name) and not GEMM_64.search(name):
            found[name[:90]] = found.get(name[:90], 0) + 1
        else:
            other += 1
    return found, other


def profiled(fn):
    """fn() under torch.profiler: (its result, the CUDA kernels' names)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def output_bytes(out) -> list:
    """The tensors of a call's output, each as its bytes."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    return [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in items if isinstance(t, torch.Tensor)]


def same_bytes(x: list, y: list) -> bool:
    return len(x) == len(y) and all(torch.equal(a, b) for a, b in zip(x, y))


def tier_invariance(cases: dict, keep=()) -> tuple[dict, dict]:
    """Phase 35 (b): each case (name -> (fn, args)) called under float32
    twice and once under each lower tier; per case, the calls whose output
    bytes differ from the first float32 call's; and for the cases in
    ``keep``, the output bytes per lower tier."""
    from pauxy_tpu_torch import config

    def call(fn, args):
        out = output_bytes(fn(*args))
        torch.cuda.synchronize()
        return out

    config.set_matmul_precision("float32", "cuda")
    ref = {k: call(*c) for k, c in cases.items()}
    differ = {k: [] for k in cases}
    kept = {k: {} for k in keep}
    for tier in ("float32",) + LADDER[1:]:
        config.set_matmul_precision(tier, "cuda")
        for k, c in cases.items():
            got = call(*c)
            if not same_bytes(got, ref[k]):
                differ[k].append(tier)
            if k in kept:
                kept[k][tier] = got
    config.set_matmul_precision("float32", "cuda")
    return differ, kept


def pinned_cases(gen) -> dict:
    """Phase 35 (b)'s plain routes on the card that stand in for a JAX
    product pinned to HIGHEST (name -> (fn, args)): the plain pivoted QR
    past the kernel's cap and unpivoted, the Taylor kernels' series past
    their caps; and, as the control that must take the tier where (a)
    says complex64 products do, the "xla" series at the same shape."""
    from pauxy_tpu_torch.ops import cpqr, cpqr_cuda, taylor_cuda
    from pauxy_tpu_torch.propagation.generic import taylor_series

    c64 = torch.complex64
    mq = cpqr_cuda.max_m(c64) + 15
    qa = torch.randn(16, mq, mq, dtype=c64, device="cuda", generator=gen)
    qs = torch.randn(64, 93, 93, dtype=c64, device="cuda", generator=gen)
    mt = taylor_cuda.max_m(c64) + 1
    vt, pt = taylor_inputs(gen, 4, mt, 14, c64)
    mb = taylor_cuda.max_m_bf16() + 1
    vb, pb = taylor_inputs(gen, 2, mb, 14, c64)
    return {
        f"plain cpqr (16,{mq})": (cpqr.cpqr, (qa,)),
        "plain cpqr unpivoted (64,93)": (cpqr.cpqr, (qs, False)),
        f"pallas series past the cap ({mt},14) w=4": (
            taylor_series, (vt, pt, 6, "pallas")),
        f"pallas_bf16 series past the cap ({mb},14) w=2": (
            taylor_series, (vb, pb, 6, "pallas_bf16")),
        f"control: xla series ({mt},14) w=4": (
            taylor_series, (vt, pt, 6, "xla")),
    }


def ladder_drivers() -> dict:
    """Phase 35 (c)'s paths: name -> build(device, dtype, tier) of a
    driver with injected-draw blocks (or paths) to run: phase 4's
    continuous Hubbard cell (16 walkers, 2 blocks), phase 10's Generic
    golden system (40 walkers, 10 blocks), phase 22's UEG golden shape (16
    walkers, 2 blocks), phase 12's thermal 3x3 Hubbard (32 walkers, 5
    paths). The Generic and UEG paths take the "xla" Taylor series, where
    the tier reaches the exponential. Population control is off (its step
    past the run's): a comb pick at a weight boundary would swap walkers
    between two runs that differ by rounding, a jump that is not the
    tier's error."""
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_hubbard, rhf_identity_trial,
                                        trial_from_orbitals)
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    def data(name):
        return np.load(os.path.join(ROOT, "tests", "data", name))

    gg, gu, gt = (data("generic_nmo11.npz"), data("ueg_rs2.44_ecut2.npz"),
                  data("thermal_hubbard3x3.npz"))
    nmo = gg["h1e"].shape[-1]
    eopts = {"mixed": {"energy_eval_freq": 1}}
    no_pop = 10 ** 6  # no comb step within a run

    def hubbard(device, dtype, tier):
        ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device=device,
                           dtype=dtype)
        return AFQMC(ham, free_electron_trial(ham, device=device,
                                              dtype=dtype),
                     QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=2,
                             nstblz=10, npop_control=no_pop, rng_seed=8),
                     propagator_options={"matmul_precision": tier},
                     estimator_options=eopts, device=device)

    def generic(device, dtype, tier):
        ham = make_generic((3, 3), np.stack([gg["h1e"], gg["h1e"]]),
                           np.asarray(gg["chol"]).reshape(-1, nmo, nmo)
                           .transpose(1, 2, 0), ecore=float(gg["enuc"]),
                           device=device, dtype=dtype)
        trial = trial_from_orbitals(ham, np.asarray(gg["psi"]),
                                    device=device, dtype=dtype)
        return AFQMC(ham, trial,
                     QMCOpts(nwalkers=int(gg["nwalkers"]), dt=float(gg["dt"]),
                             nsteps=int(gg["nsteps"]), nblocks=10, nstblz=10,
                             npop_control=no_pop, rng_seed=8),
                     propagator_options={"matmul_precision": tier,
                                         "taylor_impl": "xla"},
                     estimator_options=eopts, device=device)

    def ueg(device, dtype, tier):
        ham = make_ueg(int(gu["nup"]), int(gu["ndown"]), rs=float(gu["rs"]),
                       ecut=float(gu["ecut"]), device=device, dtype=dtype)
        return AFQMC(ham, rhf_identity_trial(ham, device=device, dtype=dtype),
                     QMCOpts(nwalkers=16, dt=float(gu["dt"]),
                             nsteps=int(gu["nsteps"]), nblocks=2, nstblz=10,
                             npop_control=no_pop, rng_seed=8),
                     propagator_options={"matmul_precision": tier},
                     estimator_options=eopts, device=device)

    def thermal(device, dtype, tier):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_one_body_trial(ham, float(gt["beta"]), float(gt["dt"]),
                                    mu=float(gt["mu"]), device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=int(gt["nwalkers"]), dt=float(gt["dt"]), nsteps=1,
            nblocks=5, beta=float(gt["beta"]), npop_control=no_pop,
            rng_seed=8),
            propagator_options={"matmul_precision": tier}, device=device)

    return {"hubbard": hubbard, "generic": generic, "ueg": ueg,
            "thermal": thermal}


def ladder_values(af, xi: np.ndarray, pop: np.ndarray) -> np.ndarray:
    """Per block (ETotal, unscaled weight) of a zero-temperature driver,
    or per path (ETotal, Nav) of a thermal one, with injected draws."""
    from pauxy_tpu_torch.estimators import mixed
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
    from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise

    if af.qmc.beta is None:
        return injected_blocks(af, xi, pop, af.qmc.nblocks, run_block,
                               BlockNoise, mixed)
    ns = af.ntime_slices
    rows = [thermal_injected(af, xi[i * ns:(i + 1) * ns],
                             pop[i * ns:(i + 1) * ns], PathNoise)
            for i in range(af.qmc.nblocks)]
    return np.array([[r[5].real, r[10].real] for r in rows])


def ladder_gaps(counts, zero_counts) -> tuple[dict, dict, dict, dict]:
    """Phase 35 (c): each path of ``ladder_drivers`` on the host in
    complex128 once, then on the card in complex64 under each tier with
    the same injected draws; per path and tier the largest |card - host|
    over a column's largest |host|; the launches of the card runs; the
    split GEMM's launches per path and tier; and per path the cuBLAS /
    CUTLASS float32 / complex64 GEMMs that the profiled "bfloat16_3x" run
    launched (``library_gemms``: none expected) with its other GEMMs."""
    drivers = ladder_drivers()
    rng = np.random.default_rng(35)
    gaps, launched = {}, dict.fromkeys(counts(), 0)
    split, libs = {}, {}
    taylor_ueg = os.environ.pop("PAUXY_TPU_TAYLOR_UEG", None)
    try:
        for name, build in drivers.items():
            host_af = build("cpu", "double", None)
            q = host_af.qmc
            steps = q.nblocks * (q.nsteps if q.beta is None
                                 else host_af.ntime_slices)
            xi = rng.normal(size=(steps, q.nwalkers, host_af.ham.nfields))
            pop = rng.uniform(size=(steps, 1))
            host = ladder_values(host_af, xi, pop)
            gaps[name], split[name] = {}, {}
            for tier in LADDER:
                zero_counts()
                af = build("cuda", "single", tier)
                if af.matmul_precision != tier:
                    raise AssertionError(f"{name}: driver reports "
                                         f"{af.matmul_precision}, want {tier}")
                if tier == "bfloat16_3x":
                    card, names = profiled(
                        lambda: ladder_values(af, xi, pop))
                    libs[name] = library_gemms(names)
                else:
                    card = ladder_values(af, xi, pop)
                torch.cuda.synchronize()
                for k, v in counts().items():
                    launched[k] += v
                split[name][tier] = counts()["gemm_bf16x3"]
                if not np.isfinite(card).all():
                    raise AssertionError(f"{name} {tier}: {card}")
                gaps[name][tier] = float((np.abs(card - host).max(axis=0)
                                          / np.abs(host).max(axis=0)).max())
                del af
    finally:
        if taylor_ueg is not None:
            os.environ["PAUXY_TPU_TAYLOR_UEG"] = taylor_ueg
    return gaps, launched, split, libs


def ladder_phmsd(counts, zero_counts) -> tuple[dict, dict, dict, tuple]:
    """Phase 35 (d): phase 26's PHMSD zero-variance anchor (the full space
    of 225 determinants, 256 walkers, 3 blocks of 10 steps) in complex64
    under each tier with the "xla" Taylor series: the largest relative
    |E - E_FCI| over every walker at each block's end and every block's
    ETotal; the launches; the split GEMM's launches per tier; the library
    GEMMs of the first "bfloat16_3x" block, profiled
    (``library_gemms``)."""
    from pauxy_tpu_torch.estimators import ci, mixed
    from pauxy_tpu_torch.models import make_generic, phmsd_trial
    from pauxy_tpu_torch.models.multi_slater import recompute_ci_coeffs
    from pauxy_tpu_torch.propagation.continuous import trial_greens
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2))
    occ = list(itertools.combinations(range(6), 2))
    occa = [o for o in occ for _ in occ]
    occb = [o for _ in occ for o in occ]
    host = make_generic((2, 2), h1e, chol, enuc, device="cpu",
                        dtype="double")
    e_fci = float(ci.simple_fci(host)[0][0])
    coeffs, _ = recompute_ci_coeffs(host, occa=occa, occb=occb)
    gaps, launched, split = {}, dict.fromkeys(counts(), 0), {}
    libs = ({}, 0)
    for tier in LADDER:
        ham = make_generic((2, 2), h1e, chol, enuc, device="cuda",
                           dtype="single")
        trial = phmsd_trial(ham, coeffs, occa, occb, device="cuda",
                            dtype="single")
        af = AFQMC(ham, trial, QMCOpts(nwalkers=256, dt=0.01, nsteps=10,
                                       nblocks=1, nstblz=5, npop_control=1,
                                       rng_seed=8),
                   propagator_options={"matmul_precision": tier},
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   device="cuda")
        gap, split[tier] = 0.0, 0
        for blk in range(3):
            zero_counts()
            if tier == "bfloat16_3x" and blk == 0:
                row, names = profiled(af.run_block)
                found, other = library_gemms(names)
                libs = ({**libs[0], **found}, libs[1] + other)
            else:
                row = af.run_block()
            torch.cuda.synchronize()
            for k, v in counts().items():
                launched[k] += v
            split[tier] += counts()["gemm_bf16x3"]
            ew = mixed.energy_estimator(ham, trial)(
                *trial_greens(trial, af.state.phia, af.state.phib)[:2])[0]
            gap = max(gap, float(((ew - e_fci).abs() / abs(e_fci)).max()),
                      abs(row[5].real - e_fci) / abs(e_fci))
        gaps[tier] = gap
        del af
    return gaps, launched, split, libs


def ladder_phase(tier_cases: dict, counts, zero_counts) -> tuple[str, dict,
                                                                 dict]:
    """Phase 35, the matmul-precision ladder: (a) the product errors per
    tier, the split tier's within SPLIT_PRODUCT_BOUND; (a') the split GEMM
    against its plain version (``check_gemm3``) and its times
    (``gemm3_times``); (b) every kernel (on phase 3's inputs) and the
    pinned plain routes byte for byte the same under every tier, the "xla"
    control different under each; (c) each tier's card run against the
    host's complex128 on four paths and (d) the PHMSD anchor, within
    LADDER_BOUNDS, the split GEMM launched on each path under
    "bfloat16_3x" only and no cuBLAS float32 / complex64 GEMM in those
    runs; (e) the process back at "highest" without the route. The line,
    the launches of (c) and (d)'s card runs, and the split GEMM's row of
    the kernels line."""
    from pauxy_tpu_torch import config
    from pauxy_tpu_torch.ops import gemm3_cuda

    prod = product_errors()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3535)
    gemm_err, gemm_worst, gemm_routes = check_gemm3(gen)
    gemm_t, gemm_bound, gemm_rows = gemm3_times(gen)
    pinned = pinned_cases(gen)
    control = [k for k in pinned if k.startswith("control")]
    differ, kept = tier_invariance({**tier_cases, **pinned}, control)
    held = {k: v for k, v in differ.items() if k not in control}
    if any(held.values()):
        raise AssertionError(f"tier-invariance: outputs that differ from "
                             f"the float32 call's: {held}")
    three = {k: differ[k] == list(LADDER[1:]) and not same_bytes(
        kept[k]["bfloat16_3x"], kept[k]["bfloat16"]) for k in control}
    if not all(three.values()):
        raise AssertionError(f"the xla control does not differ three ways: "
                             f"{ {k: differ[k] for k in control} }")
    gaps, launched, split, libs = ladder_gaps(counts, zero_counts)
    gaps["phmsd"], phm_launched, split["phmsd"], libs["phmsd"] = \
        ladder_phmsd(counts, zero_counts)
    for k, v in phm_launched.items():
        launched[k] += v
    missed = {(p, t): g for p, row in gaps.items() for t, g in row.items()
              if not g <= LADDER_BOUNDS[p][t]}
    unrouted = {p: s for p, s in split.items()
                if not (s["bfloat16_3x"] > 0 and s["float32"] == 0
                        and s["bfloat16"] == 0)}
    library = {p: found for p, (found, _) in libs.items() if found}
    config.set_matmul_precision("float32", "cuda")
    restored = rung_in_force()
    if (torch.get_float32_matmul_precision() != "highest"
            or gemm3_cuda.route_installed()):
        raise AssertionError(f"after the ladder: {restored}")
    if missed:
        raise AssertionError(f"ladder: card vs host over the bound "
                             f"{missed} (bounds {LADDER_BOUNDS})")
    if unrouted:
        raise AssertionError(f"split GEMM launches per tier {unrouted}: want "
                             f"some under bfloat16_3x only")
    if library:
        raise AssertionError(f"cuBLAS float32 / complex64 GEMMs under "
                             f"bfloat16_3x: {library}")
    msg = ("(a) [1024, 512] x [512, 16384] against float64, relative max "
           "error real float32 / complex64 (median ms): " + "; ".join(
               f"{t} [{p['setting']}] {p['real']:.3e} / {p['complex']:.3e} "
               f"({p['real_ms']:.4f} / {p['complex_ms']:.4f} ms)"
               for t, p in prod.items())
           + f"; bfloat16_3x <= {SPLIT_PRODUCT_BOUND:g}"
           + "; (a') gemm_bf16x3 against its plain version over "
           + ", ".join(c[0] for c in gemm3_cases(gen, torch.float32))
           + ", float32 and complex64, within 12 k eps S + 4 eps |beta||C| "
           f"(largest |d| / bound: {gemm_worst}; max |d| at the VHS shape "
           f"{gemm_err:.3e}), each on the route plan picks, launches by "
           f"route {gemm_routes}; at [1024,512]x[512,16384] f32 the wrapper "
           f"{gemm_t['kernel']:.4f} ms (device {gemm_t['device']:.4f}, "
           f"queued {gemm_t['queued']:.4f}), "
           f"plain {gemm_t['plain']:.4f}, cuBLAS float32 "
           f"{gemm_t['library']:.4f}, TF32 {gemm_t['tf32']:.4f}, bound "
           f"{gemm_bound[0]:.5f} ({gemm_bound[1]}); " + "; ".join(
               f"{r['shape']} {r['ms']:.4f} (device {r['device_ms']:.4f}, "
               f"queued {r['queued_ms']:.4f}) / "
               f"plain {r['plain_ms']:.4f} / cuBLAS {r['library_ms']:.4f} / "
               f"TF32 {r['tf32_ms']:.4f} / bound {r['bound_ms']:.5f} "
               f"({r['bound_by']})" for r in gemm_rows)
           + "; (b) byte for byte equal to the float32 call under float32 "
           "again, bfloat16_3x and bfloat16: " + ", ".join(
               k for k in {**tier_cases, **pinned} if k not in control)
           + "; " + "; ".join(
               f"{k} differs under {differ[k]}, and the two lower tiers "
               f"from each other" for k in control)
           + "; (c) complex64 on the card vs complex128 on the host, same "
           "injected draws, max |d| over the scale (bound) per tier: "
           + "; ".join(
               f"{p} " + ", ".join(
                   f"{t} {g:.3e} ({LADDER_BOUNDS[p][t]:g})"
                   for t, g in row.items())
               for p, row in gaps.items() if p != "phmsd")
           + "; (d) PHMSD max relative |E - E_FCI|, complex64, xla series: "
           + ", ".join(f"{t} {g:.3e} ({LADDER_BOUNDS['phmsd'][t]:g})"
                       for t, g in gaps["phmsd"].items())
           + "; split GEMM launches per path (float32 / bfloat16_3x / "
           "bfloat16): " + ", ".join(
               f"{p} {s['float32']} / {s['bfloat16_3x']} / {s['bfloat16']}"
               for p, s in split.items())
           + "; profiled bfloat16_3x runs: no cuBLAS float32 / complex64 "
           "GEMM, other (float64) GEMM launches " + ", ".join(
               f"{p} {n}" for p, (_, n) in libs.items())
           + f"; card launches {launched}; (e) restored: {restored}")
    row = {"err": gemm_err, "times": gemm_t, "bound": gemm_bound,
           "at_shapes": gemm_rows}
    return msg, launched, row


class LowRankERI:
    """(pq|rs) = sum_r F[pq, r] F[rs, r], F symmetric in p, q and drawn
    from ``seed``: the out-of-core Cholesky's provider (``diagonal()``,
    ``column(j, l)``), never the M^4 tensor."""

    def __init__(self, nao: int, rank: int, seed: int = 0):
        f = np.random.default_rng(seed).normal(size=(nao, nao, rank))
        self.f = (f + f.transpose(1, 0, 2)).reshape(nao * nao, rank)
        self.nao = nao

    def diagonal(self):
        return np.einsum("ir,ir->i", self.f, self.f)

    def column(self, j: int, l: int):
        return self.f @ self.f[j * self.nao + l]


def h5lite_phase() -> str:
    """Phase 36: the out-of-core Cholesky through h5lite at nao = 128 and
    the checked-in libver="latest" gzip file (see the module docstring)."""
    import tracemalloc

    from pauxy_tpu_torch.utils import from_pyscf, h5lite

    nao, rank, cmax, rows = 128, 384, 10, 64
    chunk, dataset = rows * nao * nao * 8, cmax * nao ** 3 * 8
    prov = LowRankERI(nao, rank)
    work = tempfile.mkdtemp(prefix="chip_smoke_h5lite_")
    had = "h5py" in sys.modules
    saved = sys.modules.get("h5py")
    try:
        try:
            import h5py  # noqa: F401
            h5py_here = True
        except ImportError:
            h5py_here = False
        sys.modules["h5py"] = None      # open_file falls back to h5lite
        fn = os.path.join(work, "chol.h5")
        tracemalloc.start()
        t0 = time.perf_counter()
        try:
            n = from_pyscf.chunked_cholesky_outcore(
                prov, fn, max_error=1e-8, cmax=cmax, chunk_rows=rows)
            outcore_s = time.perf_counter() - t0
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
    finally:
        if had:
            sys.modules["h5py"] = saved
        else:
            sys.modules.pop("h5py", None)
    t0 = time.perf_counter()
    ref = from_pyscf.chunked_cholesky(prov, max_error=1e-8, cmax=cmax)
    incore_s = time.perf_counter() - t0
    with h5lite.File(fn, "r") as fh5:
        got = fh5["chol_outcore"][()]
        mid = fh5["chol_outcore"][100:164]
    size = os.path.getsize(fn)
    shutil.rmtree(work, ignore_errors=True)
    err = float(np.abs(got - ref).max())
    if not (n == rank == ref.shape[0] and got.shape == ref.shape
            and err <= 1e-12 and np.array_equal(mid, got[100:164])):
        raise AssertionError(f"out-of-core Cholesky through h5lite: {n} "
                             f"vectors, max |d| {err:.3e} vs in-core")
    limit = 4 * chunk + 8 * nao * nao * 8
    if not (peak < limit and 8 * peak <= dataset):
        raise AssertionError(f"out-of-core Cholesky traced peak {peak} B: "
                             f"limit {limit} B, dataset {dataset} B")
    path = os.path.join(ROOT, "tests", "data", "h5lite_latest_gzip.h5")
    with h5lite.File(path, "r") as fh5:
        ea = fh5["ea"][()]
        ea_rows = fh5["ea"][5:13]
        links = {k: fh5[f"links/{k}"][()] for k in fh5["links"].keys()}
        filters = fh5["ea"]._node.filters
    want = np.sin(np.arange(40 * 6)).reshape(40, 6)
    want_links = {f"n{i:02d}": np.arange(i, i + 3) for i in range(12)}
    if not (np.array_equal(ea, want) and np.array_equal(ea_rows, want[5:13])
            and list(links) == list(want_links) and filters
            and all(np.array_equal(links[k], v)
                    for k, v in want_links.items())):
        raise AssertionError("tests/data/h5lite_latest_gzip.h5 misread")
    mb = 1e6
    return (f"h5py {'present, hidden' if h5py_here else 'absent'}; "
            f"out-of-core Cholesky through h5lite at nao {nao}, rank {rank}, "
            f"cmax {cmax}, chunks of {rows} rows: {n} vectors in "
            f"{outcore_s:.3f} s (in-core {incore_s:.3f} s), max |d| "
            f"{err:.3e} <= 1e-12 vs in-core; tracemalloc peak "
            f"{peak / mb:.3f} MB against the dataset's {dataset / mb:.3f} MB "
            f"(a chunk {chunk / mb:.3f} MB; limit {limit / mb:.3f} MB, "
            f"dataset / peak {dataset / peak:.2f} >= 8), file "
            f"{size / mb:.3f} MB; h5lite_latest_gzip.h5 (deflate + shuffle, "
            f"extensible-array index, 12 links in dense storage) read equal "
            f"to its values")


# Phase 37's cases: (ecut, na, nb, w) at the UEG cells' cube (N = 17, M =
# 257) and the largest cube the kernel takes in each type (N = 25 complex64,
# N = 21 complex128).
PW_CASES = {torch.complex64: ((8.0, 7, 7, 1024), (8.0, 7, 7, 1536),
                              (8.0, 7, 7, 37), (8.0, 1, 0, 37),
                              (8.0, 3, 5, 37), (18.0, 7, 7, 37)),
            torch.complex128: ((8.0, 7, 7, 1024), (8.0, 7, 7, 1536),
                               (8.0, 7, 7, 37), (8.0, 1, 0, 37),
                               (8.0, 3, 5, 37), (12.5, 7, 7, 37))}


def pw_force_bias_inputs(ecut: float, na: int, nb: int, w: int, dtype,
                         seed: int = 0, device="cuda"):
    """(ct_f, gha, ghb, tables, ham, (psia, psib)) of the plane-wave force
    bias on the UEG cube of ``ecut``: a dense random trial (not the
    identity's columns) and random half-rotated Green's functions, scaled
    as a walker's are (|Ghalf| ~ 1 on the occupied orbitals)."""
    from pauxy_tpu_torch.config import real_dtype
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.ops import pw_force_bias_cuda as fb

    ham = make_ueg(max(na, 1), max(nb, 1), rs=1.0, ecut=ecut, device=device,
                   dtype="double")
    m = ham.nbasis
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def cx(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.complex128)

    psi = torch.linalg.qr(cx(m, na + nb))[0]
    gh = cx(w, na + nb, m) * 0.2
    gh[:, :, :na + nb] += torch.eye(na + nb, dtype=gh.dtype)
    qfac = (ham.vqvec / (4.0 * ham.vol)).sqrt().to(real_dtype(dtype))
    tab = fb.make_tables(ham.gmap, ham.qmap, ham.qmesh, qfac, 0.005 ** 0.5)
    psi = psi.to(device, dtype)
    psia, psib = psi[:, :na].contiguous(), psi[:, na:].contiguous()
    ct_f = fb.trial_cubes(psia, psib, ham.gmap, ham.qmesh)
    gh = gh.to(device, dtype)
    return ct_f, gh[:, :na], gh[:, na:], tab, ham, (psia, psib)


def pw_force_bias_work(n: int, ngrid: int, nq: int, m: int, w: int,
                       dtype) -> tuple[float, float]:
    """(bytes, operations) of the fused force bias on w walkers: Ghalf in
    and the fields out once; each orbital's pruned passes and its product
    into the cube, and the final transform's three full passes. A line of
    N points with Q input pairs counts the fewer of the kernel's direct
    DFT (6 Q adds and (N - 1) / 2 output pairs of 8 Q + 4) and an FFT's
    5 N log2 N: the pruned lines at their direct count, the final
    transform's full lines at an FFT's."""
    isz = dtype.itemsize
    s = 2 * ((ngrid - 1) // 4) + 1
    h = (ngrid - 1) // 2

    def line(q):
        return min(6 * q + h * (8 * q + 4), 5 * ngrid * np.log2(ngrid))

    orbital = ((s * s + s * ngrid + ngrid ** 2) * line((s - 1) // 2)
               + 8 * ngrid ** 3)
    final = 3 * ngrid ** 2 * line(h)
    return (w * (n * m + 2 * nq) * isz, w * (n * orbital + final))


def pw_fft_route(ct_psi, gha, ghb, tab):
    """The torch.fft route that the kernel replaces on the card: each
    spin's ``fft_coulomb_terms`` and the glue of ``PlaneWave.force_bias``
    (the same function, qfac and sqrt(dt) folded into ``tab.fac``)."""
    from pauxy_tpu_torch.estimators.local_energy import fft_coulomb_terms

    psia, psib = ct_psi
    qmap = tab.qidx[0].long()
    ng = int(np.prod(tab.qmesh))
    ka, pa = fft_coulomb_terms(psia, gha, tab.gmap, qmap, tab.qmesh)
    if psib.shape[-1]:
        kb, pb = fft_coulomb_terms(psib, ghb, tab.gmap, qmap, tab.qmesh)
        ka, pa = ka + kb, pa + pb
    t1, t2 = tab.fac * ng * ka, tab.fac * ng * pa
    return -torch.cat([1j * (t1 + t2), -(t1 - t2)], dim=-1)


def pw_force_bias_phase() -> tuple[str, dict]:
    """Phase 37: the plane-wave force-bias kernel against its plain
    version, its route past the largest cube it takes (and that route's
    memory peak beside the per-spin torch.fft chains'), and its times at
    the UEG cells' shape (see the module docstring). The line, and the
    kernel's row of the kernels line."""
    from pauxy_tpu_torch.models import make_ueg, rhf_identity_trial
    from pauxy_tpu_torch.ops import pw_force_bias_cuda as fb
    from pauxy_tpu_torch.ops.greens import SpinGreens
    from pauxy_tpu_torch.propagation.planewave import make_planewave

    errs, abs_err = [], 0.0
    for dtype, cases in PW_CASES.items():
        for ecut, na, nb, w in cases:
            ct_f, gha, ghb, tab, _, _ = pw_force_bias_inputs(ecut, na, nb,
                                                             w, dtype)
            if not fb.fits(tab, dtype):
                raise AssertionError(f"pw force bias: cube {tab.qmesh} in "
                                     f"{dtype} not taken by the kernel")
            before = fb.launches
            got = fb.force_bias(ct_f, gha, ghb, tab)
            torch.cuda.synchronize()
            want = fb.force_bias_plain(ct_f, gha, ghb, tab)
            err = float((got - want).abs().max() / want.abs().max())
            if not (fb.launches == before + 1 and err <= TOL[dtype]):
                raise AssertionError(f"pw force bias {dtype} N "
                                     f"{tab.qmesh[0]} ({na}, {nb}) w {w}: "
                                     f"relative {err:.3e} > {TOL[dtype]}")
            errs.append(f"{str(dtype)[6:]} N{tab.qmesh[0]} ({na},{nb}) w{w} "
                        f"{err:.2e}")
            if dtype == torch.complex64:
                abs_err = max(abs_err, float((got - want).abs().max()))
            del ct_f, gha, ghb, want, got
    # A cube past the kernel (N = 25 in complex128) takes the torch.fft
    # route of PlaneWave.force_bias on the card, without a launch.
    ham = make_ueg(7, 7, rs=1.0, ecut=18.0, device="cuda", dtype="double")
    trial = rhf_identity_trial(ham, device="cuda", dtype="double")
    prop = make_planewave(ham, trial, 0.005, device="cuda", dtype="double")
    if fb.fits(prop.fb_tables, torch.complex128):
        raise AssertionError("pw force bias: N = 25 complex128 fits")
    _, gha, ghb, _, _, _ = pw_force_bias_inputs(18.0, 7, 7, 5,
                                                torch.complex128)
    before = fb.launches
    big = prop.force_bias(trial, SpinGreens(None, gha, None),
                          SpinGreens(None, ghb, None))
    torch.cuda.synchronize()
    want = fb.force_bias_plain(prop.trial_cubes(trial), gha, ghb,
                               prop.fb_tables)
    big_err = float((big - want).abs().max() / want.abs().max())
    if fb.launches != before or big_err > 1e-12:
        raise AssertionError(f"pw force bias past the kernel: launches "
                             f"{fb.launches - before}, {big_err:.3e}")
    # That route's device-memory peak above its inputs at 64 walkers,
    # beside the per-spin torch.fft chains it stands for (one spin's
    # orbital cubes live at a time in both).
    ct_f, gha, ghb, tab, _, psi = pw_force_bias_inputs(18.0, 7, 7, 64,
                                                       torch.complex128)
    peaks = {}
    for name, fn in (("plain", lambda: fb.force_bias_plain(ct_f, gha, ghb,
                                                           tab)),
                     ("per-spin", lambda: pw_fft_route(psi, gha, ghb,
                                                       tab))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del out
    if peaks["plain"] > peaks["per-spin"]:
        raise AssertionError(f"pw force bias past the kernel: peak {peaks}")
    del prop, trial, ham, ct_f, gha, ghb
    # Times at the cells' shape, complex64: the kernel, its plain version
    # and the torch.fft route it replaces (the library's transforms).
    shapes, rows = [], []
    for w in (1024, 1536):
        ct_f, gha, ghb, tab, ham, psi = pw_force_bias_inputs(
            8.0, 7, 7, w, torch.complex64)
        t = median_ms({
            "plain": lambda: fb.force_bias_plain(ct_f, gha, ghb, tab),
            "kernel": lambda: fb.force_bias(ct_f, gha, ghb, tab),
            "library": lambda: pw_fft_route(psi, gha, ghb, tab)})
        t["device"] = device_ms(lambda: fb.force_bias(ct_f, gha, ghb, tab),
                                "pw_force_bias")
        nbytes, flops = pw_force_bias_work(14, 17, tab.fac.shape[0],
                                           ham.nbasis, w, torch.complex64)
        bound = bound_ms(nbytes, flops, torch.complex64)
        shapes.append(f"w={w}: kernel {t['kernel']:.4f} ms (device "
                      f"{t['device']:.4f}), plain {t['plain']:.4f}, torch.fft "
                      f"route {t['library']:.4f}, bound {bound[0]:.4f} "
                      f"({bound[1]}: {nbytes / 1e6:.1f} MB, "
                      f"{flops / 1e9:.3f} GFLOP)")
        rows.append((t, bound, {
            "shape": f"(17^3, 7+7, M=257) w={w} c64", "ms": t["kernel"],
            "device_ms": t["device"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound[0],
            "bound_by": bound[1]}))
        del ct_f, gha, ghb
    row = {"err": abs_err, "times": rows[0][0], "bound": rows[0][1],
           "at_shapes": [r[2] for r in rows]}
    return ("kernel vs plain, relative to max|out| (order of the sums: "
            "direct DFTs vs torch.fft), tolerance 1e-4 complex64 / 1e-10 "
            "complex128: " + ", ".join(errs) + f"; N=25 complex128 past the "
            f"kernel: the plain version (torch.fft), no launch, "
            f"{big_err:.2e}; its peak above the inputs at 64 walkers "
            f"{peaks['plain']} B, the per-spin torch.fft chains' "
            f"{peaks['per-spin']} B; at (17^3, 7+7, M=257) complex64 "
            + "; ".join(shapes)), row


def main() -> None:
    seconds = {}
    t_phase = time.perf_counter()

    def lap(phase: str) -> str:
        """Seconds since the last lap, recorded under ``phase``."""
        nonlocal t_phase
        now = time.perf_counter()
        seconds[phase] = round(now - t_phase, 1)
        t_phase = now
        return f" ({seconds[phase]} s)"

    # ---- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check needs the "
                         "card and has no CPU fallback")
    sys.path.insert(0, ROOT)
    import pauxy_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(pauxy_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        raise SystemExit(f"chip_smoke: pauxy_tpu_torch found at {pkg_dir}, "
                         f"not beside this script in {ROOT}")
    from pauxy_tpu_torch.estimators import ci, local_energy, mixed
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_ghf_trial, make_hubbard,
                                        multi_slater_trial, phmsd_trial,
                                        rhf_identity_trial,
                                        trial_from_orbitals)
    from pauxy_tpu_torch.models.multi_slater import (
        greens_function_multi_det, log_overlap_multi_det,
        recompute_ci_coeffs)
    from pauxy_tpu_torch.models import trial as trial_module
    from pauxy_tpu_torch.models.hubbard_holstein import (
        coherent_state_trial, lang_firsov_trial, make_hubbard_holstein)
    from pauxy_tpu_torch.models.multi_coherent import multi_coherent_trial
    from pauxy_tpu_torch.ops import greens
    from pauxy_tpu_torch.propagation.continuous import RIDraws
    from pauxy_tpu_torch.propagation.hirsch_dmc import DMCDraws
    from pauxy_tpu_torch.walkers import init_walkers
    from pauxy_tpu_torch.models.thermal_trial import (make_mean_field_trial,
                                                      make_one_body_trial)
    from pauxy_tpu_torch.models.pw_fft import make_pw_fft
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.ops import (batchla_cuda, clinalg, cpqr_cuda,
                                     cuda_build, exx_cuda, greens_cuda,
                                     sweep_cuda, taylor_cuda)
    from pauxy_tpu_torch.propagation.continuous import trial_greens
    from pauxy_tpu_torch.propagation.generic import (GenericContinuous,
                                                     apply_exponential_taylor)
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
    from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise, ThermalAFQMC
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian
    from pauxy_tpu_torch.walkers import low_rank

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "pauxy_tpu")]
    if bad:
        raise SystemExit(f"chip_smoke: JAX modules imported: {bad}")
    card = nvidia_smi()
    say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"nvidia-smi: {card}" + lap("1"))
    if "--h5lite" in sys.argv[1:]:
        # Phases 1 and 36 only; no result line.
        say("36 h5lite", h5lite_phase() + lap("36"))
        return
    if "--pw-force-bias" in sys.argv[1:]:
        # Phases 1, 2 and 37 only; no result line.
        path, nvcc_s = cuda_build.build()
        cuda_build.library()
        log = path.with_suffix(".log").read_text()
        sec = log.split("== pw_force_bias.cu")[-1].split("\n== ")[0]
        say("2 build", f"nvcc {nvcc_s:.1f}s; pw_force_bias.cu: " + " | ".join(
            ln.split("ptxas info    : ")[-1] for ln in sec.splitlines()
            if "Used" in ln or "spill" in ln) + lap("2"))
        say("37 pw force bias", pw_force_bias_phase()[0] + lap("37"))
        return

    counts, zero_counts = kernel_counts, zero_kernel_counts

    def only(**nonzero) -> dict:
        want = dict.fromkeys(counts(), 0)
        want.update(nonzero)
        return want

    # ---- 2. build --------------------------------------------------------
    path, nvcc_s = cuda_build.build()
    cuda_build.library()
    log = path.with_suffix(".log")
    usage = []
    if log.exists():
        usage = [line.split("ptxas info    : ")[-1] for line in
                 log.read_text().splitlines() if "Used" in line]
    say("2 build", f"{os.path.relpath(path, ROOT)} nvcc {nvcc_s:.1f}s "
        f"(0 = cached); " + " | ".join(usage) + lap("2"))

    # ---- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(2024)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    exx_err, exx_readings = check_exx(exx_cuda, gen)
    err = {"greens_lanes": check_greens(greens_cuda, rng),
           "inv_logdet_lanes": check_batchla(batchla_cuda, rng),
           "chol_inv_lanes": check_chol(batchla_cuda, rng),
           "hirsch_sweep": check_sweep(sweep_cuda, rng),
           "taylor_exp": check_taylor(taylor_cuda, gen),
           "exx": exx_err}
    err["cpqr"], cpqr_readings = check_cpqr(cpqr_cuda, rng)
    err["taylor_bf16"], bf16_readings = check_taylor_bf16(taylor_cuda, gen)
    b93_route = check_batchla_thermal(batchla_cuda, clinalg, rng)
    masked = check_cpqr_masked(cpqr_cuda, low_rank, rng)
    greens_route = check_greens_route(greens_cuda, rng)
    taylor_route = check_taylor_route(taylor_cuda, GenericContinuous, gen)
    ill = check_batchla_ill(batchla_cuda, rng)
    zero_pivot = check_zero_pivot(batchla_cuda, greens_cuda)
    m, n, w = 16, 7, 1024
    c64, f32 = torch.complex64, torch.float32
    psi = torch.from_numpy(rng.normal(size=(m, n)) + 0j).to("cuda", c64)
    phi = (psi[:, :, None] + 0.3 * torch.randn(m, n, w, dtype=c64,
                                               device="cuda")).contiguous()
    s = torch.einsum("mnw,mk->wnk", phi, psi.conj()).contiguous()
    g = torch.from_numpy(hpd(rng, w, n)).to("cuda", c64)
    sw = sweep_inputs(rng, m, n, n, w, f32)
    # Phase 35 calls each kernel again on its inputs here under every
    # matmul tier (name -> (wrapper, arguments)).
    tier_cases = {
        "greens_lanes": (greens_cuda.greens_lanes, (psi, phi, True)),
        "inv_logdet_lanes": (batchla_cuda.inv_logdet_lanes, (s, True)),
        "chol_inv_lanes": (batchla_cuda.chol_inv_lanes, (g,)),
        "hirsch_sweep": (sweep_cuda.hirsch_sweep_real, sw)}
    times = {
        "greens_lanes": median_ms({
            "plain": lambda: greens_cuda.greens_lanes_plain(psi, phi, True),
            "kernel": lambda: greens_cuda.greens_lanes(psi, phi, True)}),
        "inv_logdet_lanes": median_ms({
            "plain": lambda: batchla_cuda.inv_logdet_plain(s, False),
            "kernel": lambda: batchla_cuda.inv_logdet_lanes(s, False),
            "library": lambda: torch.linalg.slogdet(s)}),
        "chol_inv_lanes": median_ms({
            "plain": lambda: batchla_cuda.chol_inv_lanes_plain(g),
            "kernel": lambda: batchla_cuda.chol_inv_lanes(g),
            "two_calls": lambda: chol_two_calls(g)}),
        "hirsch_sweep": median_ms({
            "plain": lambda: sweep_cuda.hirsch_sweep_real_plain(*sw),
            "kernel": lambda: sweep_cuda.hirsch_sweep_real(*sw)}),
    }
    # Taylor at the bench shape; the yardstick is the port's own "xla"
    # route (six batched matmuls, the JAX default).
    tm, tc, tw = 128, 32, 1024
    vt, pt = taylor_inputs(gen, tw, tm, tc, torch.complex64)
    tier_cases["taylor_exp"] = (taylor_cuda.apply_taylor, (vt, pt))
    times["taylor_exp"] = median_ms({
        "plain": lambda: taylor_cuda.apply_taylor_plain(vt, pt),
        "kernel": lambda: taylor_cuda.apply_taylor(vt, pt),
        "library": lambda: apply_exponential_taylor(vt, pt)})
    # The bf16 tier at the UEG bench shape (phase 21's): the resident
    # kernel (the route there), the streaming kernel forced, the float32
    # kernel; the yardstick is the "xla" route in complex64, as in row 5.
    bm, bc, bw = 257, 14, 512
    vb16, pb16 = taylor_inputs(gen, bw, bm, bc, torch.complex64)

    def bf16_streaming(v, p):
        return lambda: taylor_cuda._apply_taylor_bf16(v, p, 6,
                                                      route="streaming")

    tier_cases["taylor_bf16"] = (
        lambda v, p: taylor_cuda.apply_taylor(v, p, lowp=True), (vb16, pb16))
    times["taylor_bf16"] = median_ms({
        "plain": lambda: taylor_cuda.apply_taylor_plain(vb16, pb16,
                                                        lowp=True),
        "kernel": lambda: taylor_cuda.apply_taylor(vb16, pb16, lowp=True),
        "streaming": bf16_streaming(vb16, pb16),
        "f32_kernel": lambda: taylor_cuda.apply_taylor(vb16, pb16),
        "library": lambda: apply_exponential_taylor(vb16, pb16)})
    # exx past the cap (the path that runs it); the yardstick is the einsum
    # route, which is also the plain version.
    ex, en, em, ew = 1024, 42, 228, 256
    rce, ghe = exx_inputs(gen, ex, en, em, ew, torch.complex64)
    times["exx"] = median_ms({
        "plain": lambda: exx_cuda.exx_plain(rce, ghe),
        "kernel": lambda: exx_cuda.exx(rce, ghe),
        "library": lambda: exx_cuda.exx_plain(rce, ghe)}, reps=5)
    tier_cases["exx"] = (exx_cuda.exx, (rce, ghe))
    del rce, ghe
    # The pivoted QR at the thermal UEG shape (B = 2 x 256 walkers, M=93);
    # PyTorch has no pivoted QR, so no library call.
    qa = torch.randn(512, 93, 93, dtype=c64, device="cuda", generator=gen)
    tier_cases["cpqr"] = (cpqr_cuda.cpqr_lanes, (qa,))
    times["cpqr"] = median_ms({
        "plain": lambda: cpqr_cuda.cpqr_lanes_plain(qa),
        "kernel": lambda: cpqr_cuda.cpqr_lanes(qa)}, reps=10)
    # The kernels' own device time (profiler), beside the wrapper's.
    times["cpqr"]["device"] = device_ms(lambda: cpqr_cuda.cpqr_lanes(qa),
                                        "cpqr")
    times["greens_lanes"]["device"] = device_ms(
        lambda: greens_cuda.greens_lanes(psi, phi, True), "greens_lanes")
    times["chol_inv_lanes"]["device"] = device_ms(
        lambda: batchla_cuda.chol_inv_lanes(g), "chol_inv")
    times["hirsch_sweep"]["device"] = device_ms(
        lambda: sweep_cuda.hirsch_sweep_real(*sw), "hirsch_sweep")
    times["taylor_bf16"]["device"] = device_ms(
        lambda: taylor_cuda.apply_taylor(vb16, pb16, lowp=True),
        "taylor_bf16_resident")
    times["taylor_bf16"]["streaming_device"] = device_ms(
        bf16_streaming(vb16, pb16), "taylor_bf16_kernel")
    del qa
    work = {
        "greens_lanes": greens_work(m, n, w),
        "inv_logdet_lanes": batchla_work(n, w, False),
        "chol_inv_lanes": chol_work(n, w),
        "hirsch_sweep": sweep_work(m, n, n, w),
        "taylor_exp": taylor_work(tm, tc, tw),
        "taylor_bf16": taylor_bf16_work(bm, bc, bw),
        "exx": exx_work(ex, en, em, ew),
        "cpqr": cpqr_work(93, 512),
    }
    bounds = {k: bound_ms(*v) for k, v in work.items()}

    # The other shapes the main paths give the kernels (complex64): kernel
    # B and the Cholesky kernel on the Generic paths (n=16 with 1024
    # walkers, n=42 with 256), Taylor past the cap, exx at the bench shape
    # (with the supermatrix GEMM that the path takes there).
    at_shapes = {k: [] for k in times}

    def at_shape(kernel, shape, fns, wk, reps=25, dev_key=None):
        t = median_ms(fns, reps)
        if dev_key is not None:
            t["device_ms"] = device_ms(fns["kernel"], dev_key)
        bnd = bound_ms(*wk)
        at_shapes[kernel].append({
            "shape": shape, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t.get("library"), "bound_ms": bnd[0],
            "bound_by": bnd[1], **{k: v for k, v in t.items()
                                   if k not in ("kernel", "plain",
                                                "library")}})

    # Kernel B at the Generic paths' shapes; the library call is
    # torch.linalg.inv or slogdet.
    for gn, gw in ((16, 1024), (42, 256)):
        sg = torch.from_numpy(2.0 * np.eye(gn) + 0.3 / np.sqrt(gn) * (
            rng.normal(size=(gw, gn, gn))
            + 1j * rng.normal(size=(gw, gn, gn)))).to("cuda", c64)
        for want_inv in (True, False):
            fns = {"plain": lambda: batchla_cuda.inv_logdet_plain(
                       sg, want_inv),
                   "kernel": lambda: batchla_cuda.inv_logdet_lanes(
                       sg, want_inv),
                   "library": ((lambda: torch.linalg.inv(sg)) if want_inv
                               else (lambda: torch.linalg.slogdet(sg)))}
            at_shape("inv_logdet_lanes",
                     f"n={gn} w={gw} c64 "
                     + ("inverse+log-det" if want_inv else "log-det only"),
                     fns, batchla_work(gn, gw, want_inv))
        hg = torch.from_numpy(hpd(rng, gw, gn)).to("cuda", c64)
        at_shape("chol_inv_lanes", f"n={gn} w={gw} c64",
                 {"plain": lambda: batchla_cuda.chol_inv_lanes_plain(hg),
                  "kernel": lambda: batchla_cuda.chol_inv_lanes(hg),
                  "two_calls": lambda: chol_two_calls(hg)},
                 chol_work(gn, gw), dev_key="chol_inv")
    at_shape("taylor_exp", "(M,C)=(257,14) w=512 c64 (the UEG bench class)",
             {"plain": lambda: taylor_cuda.apply_taylor_plain(vb16, pb16),
              "kernel": lambda: taylor_cuda.apply_taylor(vb16, pb16),
              "library": lambda: apply_exponential_taylor(vb16, pb16)},
             taylor_work(bm, bc, bw))
    del vb16, pb16
    # The bf16 kernel's two routes at the UEG golden's shape (phase 22).
    vg16, pg16 = taylor_inputs(gen, 40, 33, 14, torch.complex64)
    at_shape("taylor_bf16", "(M,C)=(33,14) w=40 c64 (the UEG golden class)",
             {"plain": lambda: taylor_cuda.apply_taylor_plain(vg16, pg16,
                                                              lowp=True),
              "kernel": lambda: taylor_cuda.apply_taylor(vg16, pg16,
                                                         lowp=True),
              "streaming": bf16_streaming(vg16, pg16),
              "library": lambda: apply_exponential_taylor(vg16, pg16)},
             taylor_bf16_work(33, 14, 40), dev_key="taylor_bf16_resident")
    at_shapes["taylor_bf16"][-1]["streaming_device_ms"] = device_ms(
        bf16_streaming(vg16, pg16), "taylor_bf16_kernel")
    del vg16, pg16
    vb, pb = taylor_inputs(gen, 256, 228, 84, torch.complex64)
    at_shape("taylor_exp", "(M,C)=(228,84) w=256 c64",
             {"plain": lambda: taylor_cuda.apply_taylor_plain(vb, pb),
              "kernel": lambda: taylor_cuda.apply_taylor(vb, pb),
              "library": lambda: apply_exponential_taylor(vb, pb)},
             taylor_work(228, 84, 256), reps=10)
    del vb, pb
    rcs, ghs = exx_inputs(gen, 512, 16, 128, 1024, torch.complex64)
    sup = torch.from_numpy(
        trial_module._exx_supermatrix(rcs.cpu().numpy())).to("cuda", f32)
    at_shape("exx", "(X,n,M)=(512,16,128) w=1024 c64",
             {"plain": lambda: exx_cuda.exx_plain(rcs, ghs),
              "kernel": lambda: exx_cuda.exx(rcs, ghs),
              "library": lambda: exx_cuda.exx_plain(rcs, ghs),
              "supermatrix_ms": lambda: local_energy._exx(rcs, ghs, sup)},
             exx_work(512, 16, 128, 1024), reps=10)
    sup_err = float((local_energy._exx(rcs, ghs, sup)
                     - exx_cuda.exx(rcs, ghs)).abs().max()
                    / exx_cuda.exx_magnitude(rcs, ghs).max())
    del rcs, ghs, sup
    # The thermal shapes: kernel B at n=93 with 512 matrices (the QDT
    # assembly; the library calls torch.linalg.inv and slogdet), the
    # pivoted QR at the Hubbard thermal shape (2 x 32 walkers, m=9).
    st = torch.from_numpy(2.0 * np.eye(93) + 0.3 / np.sqrt(93) * (
        rng.normal(size=(512, 93, 93))
        + 1j * rng.normal(size=(512, 93, 93)))).to("cuda", c64)
    for want_inv in (True, False):
        fns = {"plain": lambda: batchla_cuda.inv_logdet_plain(st, want_inv),
               "kernel": lambda: batchla_cuda.inv_logdet_lanes(st, want_inv),
               "library": ((lambda: torch.linalg.inv(st)) if want_inv
                           else (lambda: torch.linalg.slogdet(st)))}
        at_shape("inv_logdet_lanes",
                 "n=93 w=512 c64 " + ("inverse+log-det" if want_inv
                                      else "log-det only"),
                 fns, batchla_work(93, 512, want_inv), reps=10)
    del st
    qh = torch.randn(64, 9, 9, dtype=c64, device="cuda", generator=gen)
    at_shape("cpqr", "(B,m)=(64,9) c64",
             {"plain": lambda: cpqr_cuda.cpqr_lanes_plain(qh),
              "kernel": lambda: cpqr_cuda.cpqr_lanes(qh)}, cpqr_work(9, 64),
             dev_key="cpqr")
    qd = torch.randn(512, 93, 93, dtype=torch.complex128, device="cuda",
                     generator=gen)
    at_shape("cpqr", "(B,m)=(512,93) c128",
             {"plain": lambda: cpqr_cuda.cpqr_lanes_plain(qd),
              "kernel": lambda: cpqr_cuda.cpqr_lanes(qd)},
             cpqr_work(93, 512, torch.complex128), reps=5, dev_key="cpqr")
    del qd
    # The low-rank combine's masked input: 73 live columns, so 73
    # reflectors do work.
    qm = torch.from_numpy(masked_core(rng, 512, 93, 10, 20)[0]).to("cuda",
                                                                   c64)
    at_shape("cpqr", "(B,m)=(512,93) c64 masked (73 live)",
             {"plain": lambda: cpqr_cuda.cpqr_lanes_plain(qm),
              "kernel": lambda: cpqr_cuda.cpqr_lanes(qm)},
             cpqr_work(93, 512, live=73), reps=10, dev_key="cpqr")
    del qm
    # Kernel A with one walker and with a ragged 37: the chain of one
    # walker, not the card's width, sets its time.
    for gw in (1, 37):
        pg = phi[:, :, :gw].contiguous()
        at_shape("greens_lanes", f"(M,n)=(16,7) W={gw} c64",
                 {"plain": lambda: greens_cuda.greens_lanes_plain(psi, pg),
                  "kernel": lambda: greens_cuda.greens_lanes(psi, pg)},
                 greens_work(m, n, gw), dev_key="greens_lanes")
    say("3 kernels", "greens_lanes, inv_logdet_lanes (complex and real, "
        "n=1 to 64 and the cap, pivot-needing matrices), "
        "chol_inv_lanes and hirsch_sweep agree with their plain versions at "
        "every shape (complex64/float32 1e-4, complex128/float64 1e-10, "
        "sweep fields identical); at the main-path shapes "
        "(greens (16,7) W=1024 c64; inv_logdet n=7 w=1024 c64 log-det only; "
        "chol n=7 w=1024 c64; sweep (16,7,7) W=1024 f32; taylor (128,32) "
        "w=1024 c64 with the xla route as library call; exx (1024,42,228) "
        "w=256 c64 with the einsum route as library call; cpqr (512,93) "
        "c64, no library call): " + "; ".join(
            f"{k} kernel {t['kernel']:.4f} ms"
            + (f" (device {t['device']:.4f} ms)" if "device" in t else "")
            + f" vs plain {t['plain']:.4f} ms"
            + (f" vs library {t['library']:.4f} ms" if "library" in t
               else "")
            + (f" vs two library calls {t['two_calls']:.4f} ms"
               if "two_calls" in t else "")
            + (f" vs the streaming route {t['streaming']:.4f} ms (device "
               f"{t['streaming_device']:.4f} ms)" if "streaming" in t else "")
            + (f" vs the float32 kernel {t['f32_kernel']:.4f} ms"
               if "f32_kernel" in t else "")
            + f", bound {bounds[k][0]:.5f} ms ({bounds[k][1]}), max abs err "
            f"{err[k]:.3e}" for k, t in times.items()))
    say("3 kernels", "at the other main-path shapes (kernel / plain / "
        "library / bound ms): " + "; ".join(
            f"{k} {e['shape']} {e['ms']:.4f}"
            + (f" (device {e['device_ms']:.4f})" if "device_ms" in e else "")
            + f" / {e['plain_ms']:.4f} / "
            + (f"{e['library_ms']:.4f}" if e["library_ms"] is not None
               else "none")
            + f" / {e['bound_ms']:.5f} ({e['bound_by']})"
            + (f" supermatrix GEMM {e['supermatrix_ms']:.4f}"
               if "supermatrix_ms" in e else "")
            + (f" two library calls {e['two_calls']:.4f}"
               if "two_calls" in e else "")
            + (f" streaming route {e['streaming']:.4f} (device "
               f"{e['streaming_device_ms']:.4f})" if "streaming" in e else "")
            for k, es in at_shapes.items() for e in es)
        + f" (supermatrix vs kernel max |d|/S {sup_err:.3e})")
    say("3 kernels", "apply_taylor at (M,C) in {(16,14),(128,32),(228,84),"
        "(257,14),(cap,14)} w in {1,37,1024} launches and agrees with its "
        "plain version (max|d| <= tol max|out|); M = cap + 1 takes the plain "
        f"series by shape ({taylor_route}); greens_lanes at n = max_n "
        "with W in {1,100,1024,1031} launches and agrees with its plain "
        "version, n = max_n + 1 launches "
        f"nothing ({greens_route}); exx at (X,n,M) in "
        "{(30,3,12),(512,16,128),(1024,42,228),(8,60,500),(4,130,200)} "
        "w in {1,37,256}, random and "
        "coherent phases, agrees walker by walker with its plain version in "
        "float64 (|d_w| <= tol S_w, tol 5e-6 c64 / 1e-13 c128), is "
        "bit-identical on a second launch, and "
        "on coherent inputs the same inputs less one Cholesky vector miss "
        "the allowance; readings max_w |d_w|/S_w (largest: kernel, plain "
        "version in its own type) and dropped vector (smallest, random / "
        "coherent phases): " + "; ".join(
            f"{k} {a:.3e}, {p:.3e} vs {b[0]:.3e} / {b[1]:.3e}"
            for k, (a, p, b) in exx_readings.items()))
    say("3 kernels", "apply_taylor(lowp=True) (the bf16 tier, "
        "csrc/taylor_bf16.cu) at (M,C) in {(33,14),(128,32),(257,14),"
        "(208,14),(288,14),(384,14),(512,14),(513,14),(257,32),(cap,14)} "
        "complex64 and (257,14) complex128, w in {1,37,512}, launches on "
        "the route route_bf16 names (and the streaming route forced at "
        "(33,14) and (257,14)) and agrees with its plain version within "
        "1e-3 of max|out| (largest "
        f"|d|/max|out|: {bf16_readings}); M = cap + 1 "
        f"({taylor_cuda.max_m_bf16() + 1}) takes the plain bf16 series by "
        "shape, without a launch")
    say("3 kernels", "cpqr at m in {9,16,36,48,93,cap} x B in {1,37,512} "
        "complex64 and complex128, and float32 at (512,93): identities "
        "within 10 m eps, exact zeros below R's diagonal, |r_kk| "
        "non-increasing, the same bits on a second launch, on separated "
        "norms the plain version's pivots and factors within tol, on "
        "Gaussian separated norms the factors against double precision, "
        "rank-7 "
        f"input finite; largest readings: {cpqr_readings}; on the low-rank "
        f"stack's masked input (512,93) with 20 dead columns and 0 or 10 "
        f"dead rows: identities, exact zeros on the dead diagonal, no nan, "
        f"and the low-rank G and log det(1 + A) within tol ({masked}); "
        f"kernel B at "
        f"n=93 w=512 and at its cap (w=37) agrees with its plain version "
        f"and the augmented Gauss-Jordan's in every type and mode, and "
        f"cap + 1 goes to torch.linalg ({b93_route})")
    say("3 kernels", "inv_logdet_lanes on ill-conditioned real input "
        "(2 I + 0.5 N; n=5, 7, 18, 42 with 1031 matrices, n=93 with 512) "
        "within max(tol, 2 n eps kappa) of its "
        "plain version and of the float64 inverse, matrix by matrix; "
        "float32 error against the float64 inverse in units of "
        f"eps kappa max|S^-1|: {ill}")
    say("3 kernels", "kernel B (every type, both modes) on exactly "
        "singular matrices (" + ", ".join(c[0] for c in ZERO_PIVOT_CASES)
        + "; the 2 I beside them exact): log|det| -inf and arg det as "
        "JAX's CPU slogdet gives it where it is finite, a zero pivot "
        "eliminating nothing; kernel A the same as its plain version: "
        + zero_pivot + lap("3"))
    del vt, pt
    if "--ladder" in sys.argv[1:]:
        # Phases 1-3 and 35 only; no result line.
        say("35 matmul ladder", ladder_phase(tier_cases, counts,
                                             zero_counts)[0] + lap("35"))
        return

    # ---- 4. the continuous main path at full width -----------------------
    nblocks, nsteps, nwalkers = 4, 10, 1024
    steps = nblocks * nsteps
    qmc = QMCOpts(nwalkers=nwalkers, dt=0.01, nsteps=nsteps, nblocks=nblocks,
                  nstblz=10, npop_control=1, rng_seed=8)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, qmc, estimator_options=eopts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    cont = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the main path: {rows}")
    want = only(greens_lanes=6 * steps, inv_logdet_lanes=2)
    if cont != want:
        raise AssertionError(f"continuous path launches {cont}, want {want}")
    timed = af.block_seconds[1:]
    rate = nwalkers * nsteps * len(timed) / sum(timed)
    say("4 main path", f"continuous, 4x4 (7,7) U=4 complex64 {nwalkers} "
        f"walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {cont}; "
        f"{rate:.1f} walker-steps/s over {len(timed)} blocks after a warm-up "
        f"block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})" + lap("4"))

    # ---- 5. continuous golden anchor -------------------------------------
    port, ref, diff, se = golden(
        "hubbard4x4_uhf_continuous.npz", None, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("5 golden", f"continuous, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f}" + lap("5"))

    # ---- 6. the discrete main path at full width -------------------------
    discrete = {"hubbard_stratonovich": "discrete"}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, qmc, propagator_options=discrete,
               estimator_options=eopts, device="cuda")
    if af.prop.sweep_kernel != "kernel":
        raise AssertionError(f"discrete sweep route {af.prop.sweep_kernel}")
    rows = af.run()
    torch.cuda.synchronize()
    disc = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the discrete path: "
                             f"{rows}")
    # Per step: kernel B 4x in the kinetic half-steps (log-det), 2x for the
    # sweep's real S^-1, 2x for the mixed energy's Green's functions; 2 at
    # set-up. Cholesky: 2 spins x 2 passes per re-orthogonalisation.
    want = only(inv_logdet_lanes=2 + 8 * steps,
                chol_inv_lanes=4 * (steps // 10), hirsch_sweep=steps)
    if disc != want:
        raise AssertionError(f"discrete path launches {disc}, want {want}")
    timed = af.block_seconds[1:]
    rate_d = nwalkers * nsteps * len(timed) / sum(timed)
    say("6 discrete path", f"discrete spin HS, single-site sweep, 4x4 (7,7) "
        f"U=4 complex64 {nwalkers} walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {disc}; "
        f"{rate_d:.1f} walker-steps/s over {len(timed)} blocks after a "
        f"warm-up block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})" + lap("6"))

    # ---- 7. discrete golden anchor ---------------------------------------
    port, ref, diff, se = golden(
        "hubbard4x4_uhf_discrete.npz", discrete, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("7 discrete golden", f"discrete, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f}" + lap("7"))

    # ---- 8. the Generic main path at the bench shape ---------------------
    pallas = {"taylor_impl": "pallas"}
    gq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=4, nstblz=5,
                 npop_control=1, rng_seed=8)
    gsteps = gq.nblocks * gq.nsteps
    zero_counts()
    ham = generic_model(128, 512, 16, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, gq, propagator_options=pallas,
               estimator_options=eopts, device="cuda")
    if trial.exx_supera is None or af.prop.inner.taylor_impl != "pallas":
        raise AssertionError("bench shape: no supermatrix or not the kernel")
    rows = af.run()
    torch.cuda.synchronize()
    gen_counts = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the Generic path: {rows}")
    # Per step: Taylor 1; kernel B 2 for the Green's functions, 2 for the
    # new overlaps, 2 for the energy; 2 at set-up. Cholesky: 2 spins x 2
    # passes per re-orthogonalisation (every 5 steps).
    want = only(taylor_exp=gsteps, inv_logdet_lanes=2 + 6 * gsteps,
                chol_inv_lanes=4 * (gsteps // gq.nstblz))
    if gen_counts != want:
        raise AssertionError(f"Generic path launches {gen_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_g = gq.nwalkers * gq.nsteps * len(timed) / sum(timed)
    say("8 Generic path", f"nmo=128 naux=512 (16,16) RHF complex64 "
        f"taylor_impl=pallas {gq.nwalkers} walkers {gsteps} steps: ETotal "
        f"per block {np.array2string(rows[:, 5].real, precision=5)} (etrial "
        f"{trial.etrial:.5f}); launches {gen_counts}; {rate_g:.1f} "
        f"walker-steps/s over {len(timed)} blocks after a warm-up block "
        f"(block seconds {', '.join(f'{t:.4f}' for t in af.block_seconds)})"
        + lap("8"))
    del ham, trial, af

    # ---- 9. Generic past the supermatrix cap -----------------------------
    xq = QMCOpts(nwalkers=256, dt=0.005, nsteps=10, nblocks=3, nstblz=5,
                 npop_control=1, rng_seed=8)
    xsteps = xq.nblocks * xq.nsteps
    zero_counts()
    ham = generic_model(228, 1024, 42, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, xq, propagator_options=pallas, device="cuda")
    setup_s = time.perf_counter() - t_phase
    if trial.exx_supera is not None or trial.exx_superb is not None:
        raise AssertionError("past the cap the trial has a supermatrix")
    rows = af.run()
    torch.cuda.synchronize()
    exx_counts = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output past the cap: {rows}")
    nenergy = xsteps // af.energy_eval_freq
    want = only(taylor_exp=xsteps, exx=2 * nenergy,
                inv_logdet_lanes=2 + 4 * xsteps + 2 * nenergy,
                chol_inv_lanes=4 * (xsteps // xq.nstblz))
    if exx_counts != want:
        raise AssertionError(f"past-the-cap launches {exx_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_x = xq.nwalkers * xq.nsteps * len(timed) / sum(timed)
    say("9 Generic past the cap", f"nmo=228 naux=1024 (42,42) RHF "
        f"complex64 taylor_impl=pallas {xq.nwalkers} walkers {xsteps} steps, "
        f"energy every {af.energy_eval_freq} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=5)} (etrial "
        f"{trial.etrial:.5f}); launches {exx_counts}; {rate_x:.1f} "
        f"walker-steps/s over {len(timed)} blocks after a warm-up block "
        f"(block seconds {', '.join(f'{t:.4f}' for t in af.block_seconds)}; "
        f"set-up {setup_s:.1f} s)" + lap("9"))
    del ham, trial, af

    # ---- 10. Generic golden anchor ---------------------------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "generic_nmo11.npz"))
    nmo = g["h1e"].shape[-1]
    golden_qmc = dict(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                      nsteps=int(g["nsteps"]), nstblz=10, npop_control=1)

    def golden_generic(device, dtype, nblocks=100, rng_seed=8):
        ham = make_generic((3, 3), np.stack([g["h1e"], g["h1e"]]),
                           np.asarray(g["chol"]).reshape(-1, nmo, nmo)
                           .transpose(1, 2, 0), ecore=float(g["enuc"]),
                           device=device, dtype=dtype)
        trial = trial_from_orbitals(ham, np.asarray(g["psi"]),
                                    device=device, dtype=dtype)
        return AFQMC(ham, trial, QMCOpts(nblocks=nblocks, rng_seed=rng_seed,
                                         **golden_qmc),
                     propagator_options=pallas, estimator_options=eopts,
                     device=device)

    # The card's complex64 path (kernels) against the port's complex128 path
    # on the host (plain versions) with the same injected draws, block by
    # block. Limit: float32's unit roundoff 6e-8 times ~30 chained rounding
    # steps per walker step times the 100 steps, 2e-4 of the block values'
    # scale (the same comparison between the port's complex64 and complex128
    # paths on a host reads 7.6e-7).
    tb = 10
    draws = np.random.default_rng(10)
    nx = g["chol"].shape[0]
    xi = draws.normal(size=(tb * golden_qmc["nsteps"],
                            golden_qmc["nwalkers"], nx))
    pop = draws.uniform(size=(tb * golden_qmc["nsteps"], 1))
    zero_counts()
    card = injected_blocks(golden_generic("cuda", "single", tb), xi, pop, tb,
                           run_block, BlockNoise, mixed)
    tight_counts = counts()
    host = injected_blocks(golden_generic("cpu", "double", tb), xi, pop, tb,
                           run_block, BlockNoise, mixed)
    tight = (np.abs(card - host).max(axis=0)
             / np.abs(host).max(axis=0)).max()
    if tight_counts["taylor_exp"] != tb * golden_qmc["nsteps"]:
        raise AssertionError(f"Generic golden system on the card: launches "
                             f"{tight_counts}")
    if not (np.isfinite(card).all() and tight <= 2e-4):
        raise AssertionError(f"Generic golden system: complex64 on the card "
                             f"{card.tolist()} vs complex128 on the host "
                             f"{host.tolist()}: {tight:.3e} > 2e-4")
    say("10 Generic golden", f"nmo=11 (3,3), 40 walkers, {tb} blocks with "
        f"injected draws: complex64 on the card (launches {tight_counts}) vs "
        f"complex128 on the host, block ETotal "
        f"{np.array2string(card[:, 0], precision=6)} vs "
        f"{np.array2string(host[:, 0], precision=6)}: max |d| over the "
        f"block values' scale (ETotal, unscaled weight) {tight:.3e} <= 2e-4")
    ref = np.asarray(g["etotal_blocks"])
    theirs = ref[len(ref) // 3:]
    means = []
    for seed in range(8, 16):
        rows = golden_generic("cuda", "single", rng_seed=seed).run()
        et = rows[:, 5].real
        if not np.isfinite(et).all():
            raise AssertionError(f"Generic golden: non-finite ETotal {et}")
        mine = et[len(et) // 3:]
        if seed == 8:
            naive = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                                   theirs.std(ddof=1)
                                   / np.sqrt(len(theirs))))
            first = float(mine.mean())
        means.append(float(mine.mean()))
    port = float(np.mean(means))
    se = float(np.hypot(np.std(means, ddof=1) / np.sqrt(len(means)),
                        reblocked_se(theirs)))
    diff = abs(port - float(theirs.mean()))
    if not diff < max(4 * se, 0.02):
        raise AssertionError(f"Generic golden missed: port {port} "
                             f"(runs {means}) reference {theirs.mean()} "
                             f"se {se}")
    say("10 Generic golden", f"sanity check: nmo=11 (3,3), 40 walkers, 100 "
        f"blocks, complex64, taylor_impl=pallas, {len(means)} runs (seeds "
        f"8-15): "
        f"port {port:.6f} (run means "
        f"{', '.join(f'{m:.4f}' for m in means)}) vs reference "
        f"{theirs.mean():.6f}, |diff| {diff:.6f} < max(4 se, 0.02) with se "
        f"{se:.6f} (run spread and reference reblocked); seed 8 alone "
        f"{first:.6f}, |diff| {abs(first - theirs.mean()):.6f} against "
        f"4 x naive se {4 * naive:.6f}" + lap("10"))

    # ---- 11. thermal UEG at the bench shape ------------------------------
    def thermal_ueg(device, dtype, nwalkers, nblocks, **options):
        ham = make_ueg(7, 7, rs=1.0, ecut=4.0, device=device, dtype=dtype)
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=nwalkers, dt=0.05, nsteps=1, nblocks=nblocks, beta=2.0,
            npop_control=1, rng_seed=8), device=device, **options)

    zero_counts()
    af = thermal_ueg("cuda", "single", 256, 2)
    shape = (af.ham.nbasis, af.ham.nfields, af.ntime_slices, af.trial.nbins,
             af.trial.stack_size)
    if shape != (93, 1500, 40, 4, 10):
        raise AssertionError(f"thermal UEG bench shape {shape}")
    rows = af.run()
    torch.cuda.synchronize()
    ueg_counts = counts()
    if not (np.isfinite(rows).all() and (rows[:, 10].real > 0).all()):
        raise AssertionError(f"thermal UEG rows {rows}")
    ncpqr, nkb = thermal_launches(4, 10, 40, af.qmc.nblocks)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if ueg_counts != want:
        raise AssertionError(f"thermal UEG launches {ueg_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_t = af.qmc.nwalkers * af.ntime_slices * len(timed) / sum(timed)
    say("11 thermal UEG", f"rs=1 ecut=4 M=93 (7,7) beta=2 dt=0.05 mu=0.9 "
        f"(40 slices, 4 bins of 10) complex64 256 walkers, pop control "
        f"every slice: ETotal per row "
        f"{np.array2string(rows[:, 5].real, precision=5)}, Nav "
        f"{np.array2string(rows[:, 10].real, precision=5)}; launches "
        f"{ueg_counts}; {rate_t:.1f} walker-slice-steps/s over "
        f"{len(timed)} path(s) after a warm-up path (path seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")
    del af
    # The card's complex64 path against the host's complex128 path, one
    # path of 16 walkers with the same injected draws. Limit: float32's
    # unit roundoff 6e-8 times the 40 slices of ~40 chained rounding steps
    # of a walker (cpqr folds, inverses, log-dets at M=93), 1e-4 of the
    # values (the port's complex64 against complex128 on a host reads
    # 3.0e-6 for ETotal and 1.9e-6 for Nav, tools/thermal_precision.py).
    draws = np.random.default_rng(11)
    xi = draws.normal(size=(40, 16, 1500))
    pop = draws.uniform(size=(40, 1))
    card = thermal_injected(thermal_ueg("cuda", "single", 16, 1), xi, pop,
                            PathNoise)
    host = thermal_injected(thermal_ueg("cpu", "double", 16, 1), xi, pop,
                            PathNoise)
    d_e = abs(card[5] - host[5]) / abs(host[5])
    d_n = abs(card[10] - host[10]) / abs(host[10])
    if not (np.isfinite(card).all() and d_e <= 1e-4 and d_n <= 1e-4):
        raise AssertionError(f"thermal UEG: complex64 on the card {card} vs "
                             f"complex128 on the host {host}: dE {d_e:.3e}, "
                             f"dNav {d_n:.3e} > 1e-4")
    say("11 thermal UEG", f"16 walkers, one path with injected draws: "
        f"complex64 on the card ETotal {card[5].real:.6f} Nav "
        f"{card[10].real:.6f} vs complex128 on the host "
        f"{host[5].real:.6f} / {host[10].real:.6f}: relative "
        f"{d_e:.3e} / {d_n:.3e} <= 1e-4" + lap("11"))

    # ---- 12. thermal Hubbard and its golden anchor -----------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "thermal_hubbard3x3.npz"))
    tnw, tbeta, tdt = int(g["nwalkers"]), float(g["beta"]), float(g["dt"])

    def thermal_hubbard(device, dtype, nblocks, rng_seed=8):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_one_body_trial(ham, tbeta, tdt, mu=float(g["mu"]),
                                    device=device, dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=tnw, dt=tdt, nsteps=1, nblocks=nblocks, beta=tbeta,
            npop_control=2, rng_seed=rng_seed), device=device)

    # Limit: 6e-8 times the 10 slices of ~100 chained rounding steps, 1e-4
    # of the values' scale (the port's complex64 against complex128 on a
    # host reads 1.5e-6, tools/thermal_precision.py).
    npaths = 5
    card_af = thermal_hubbard("cuda", "single", npaths)
    host_af = thermal_hubbard("cpu", "double", npaths)
    ns = card_af.ntime_slices
    xi = draws.normal(size=(npaths * ns, tnw, card_af.prop.nfields))
    pop = draws.uniform(size=(npaths * ns, 1))
    pairs = []
    for i in range(npaths):
        sl = slice(i * ns, (i + 1) * ns)
        c = thermal_injected(card_af, xi[sl], pop[sl], PathNoise)
        h = thermal_injected(host_af, xi[sl], pop[sl], PathNoise)
        pairs.append([c[5].real, h[5].real, c[10].real, h[10].real])
    pairs = np.array(pairs)
    tight = max(np.abs(pairs[:, 0] - pairs[:, 1]).max()
                / np.abs(pairs[:, 1]).max(),
                np.abs(pairs[:, 2] - pairs[:, 3]).max()
                / np.abs(pairs[:, 3]).max())
    if not (np.isfinite(pairs).all() and tight <= 1e-4):
        raise AssertionError(f"thermal Hubbard: card vs host {pairs}")
    zero_counts()
    gaf = thermal_hubbard("cuda", "single", 60)
    rows = gaf.run()
    torch.cuda.synchronize()
    hub_counts = counts()
    ncpqr, nkb = thermal_launches(gaf.trial.nbins, gaf.trial.stack_size,
                                  gaf.ntime_slices, 60)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if hub_counts != want:
        raise AssertionError(f"thermal Hubbard launches {hub_counts}, want "
                             f"{want}")
    et, nav = rows[1:, 5].real, rows[1:, 10].real
    ref_e, ref_n = np.asarray(g["etotal"])[1:], np.asarray(g["nav"])[1:]
    se_e = float(np.hypot(et.std(ddof=1) / np.sqrt(len(et)),
                          ref_e.std(ddof=1) / np.sqrt(len(ref_e))))
    se_n = float(np.hypot(nav.std(ddof=1) / np.sqrt(len(nav)),
                          ref_n.std(ddof=1) / np.sqrt(len(ref_n))))
    de = abs(et.mean() - ref_e.mean())
    dn = abs(nav.mean() - ref_n.mean())
    if not (np.isfinite(rows).all() and de < max(4 * se_e, 0.05)
            and dn < max(4 * se_n, 0.02)):
        raise AssertionError(f"thermal golden missed: E {et.mean()} vs "
                             f"{ref_e.mean()} (se {se_e}), Nav {nav.mean()} "
                             f"vs {ref_n.mean()} (se {se_n})")
    say("12 thermal Hubbard", f"3x3 U=4 mu={float(g['mu'])} beta={tbeta} "
        f"dt={tdt} {tnw} walkers: {npaths} paths with injected draws, "
        f"complex64 on the card vs complex128 on the host, (ETotal, Nav) "
        f"per path {pairs.round(6).tolist()}: max |d| over the scale "
        f"{tight:.3e} <= 1e-4; golden anchor over 60 paths, complex64: "
        f"E {et.mean():.6f} vs reference {ref_e.mean():.6f}, |d| {de:.6f} "
        f"< max(4 se, 0.05) with se {se_e:.6f}; Nav {nav.mean():.6f} vs "
        f"{ref_n.mean():.6f}, |d| {dn:.6f} < max(4 se, 0.02) with se "
        f"{se_n:.6f}; launches {hub_counts}" + lap("12"))
    # ---- 13. discrete BP + ITCF at full width ----------------------------
    bq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=8, nstblz=10,
                 npop_control=1, rng_seed=8)
    bsteps = bq.nblocks * bq.nsteps
    bp_itcf = {"mixed": {"energy_eval_freq": 1},
               "back_propagation": {"tau_bp": 0.4, "evaluate_energy": True},
               "itcf": {"tau_max": 0.4, "stable": True}}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, bq, propagator_options=discrete,
               estimator_options=bp_itcf, device="cuda")
    if af.prop.sweep_kernel != "kernel" or af.use_fast_block:
        raise AssertionError("BP + ITCF: not the sweep kernel's route")
    rows = af.run()
    torch.cuda.synchronize()
    bp_counts = counts()
    want = only(**discrete_schedule(bsteps, 10, 1, 40, 40, True, True))
    if bp_counts != want:
        raise AssertionError(f"BP + ITCF launches {bp_counts}, want {want}")
    bps = [r for r in af.bp_reporter.rows if "energies_40" in r]
    its = [r for r in af.itcf_reporter.rows if r["denominator"][0] != 0]
    if not (np.isfinite(rows).all() and len(bps) == 2 == len(its)
            and all(np.isfinite(v).all() for r in af.bp_reporter.rows
                    + af.itcf_reporter.rows for v in r.values())):
        raise AssertionError(f"BP + ITCF: non-finite or missing output "
                             f"({len(bps)} BP, {len(its)} ITCF)")
    tr_bp = np.array([[np.trace(r["one_rdm_40"][s]).real
                       / r["denominator_40"][0].real for s in (0, 1)]
                      for r in bps])
    d_tr = float(np.abs(tr_bp / 7.0 - 1.0).max())
    eye_gap = float(max(np.abs(r["real_space_greens_function"][0, s, 0]
                               + r["real_space_greens_function"][0, s, 1]
                               - np.eye(16)).max()
                        for r in its for s in (0, 1)))
    if not (d_tr <= 1e-4 and eye_gap <= 1e-4):
        raise AssertionError(f"BP + ITCF identities: Tr G_bp / n - 1 "
                             f"{d_tr:.3e}, G>(0) + G<(0) - I {eye_gap:.3e}")
    rate_b = bq.nwalkers * bq.nsteps * (bq.nblocks - 1) / sum(
        af.block_seconds[1:])
    e_bp = [round(float(r["energies_40"][0].real), 5) for r in bps]
    g_up = its[-1]["real_space_greens_function"][:, 0, 0, 0, 0]
    say("13 BP + ITCF", f"discrete spin HS, sweep kernel, 4x4 (7,7) U=4 "
        f"complex64 {bq.nwalkers} walkers {bsteps} steps (8 blocks of 10; "
        f"BP tau_bp=0.4 with energies, ITCF tau_max=0.4 stable): ETotal "
        f"per block {np.array2string(rows[:, 5].real, precision=4)}; BP "
        f"energies {e_bp}; ITCF G>up00(tau) at tau = 0, 0.1, 0.4: "
        f"{[round(float(g_up[k]), 5) for k in (0, 10, 40)]}"
        f"; max |Tr G_bp / n - 1| {d_tr:.2e}, max |G>(0) + G<(0) - I| "
        f"{eye_gap:.2e} (<= 1e-4); launches {bp_counts} as scheduled; "
        f"{rate_b:.1f} walker-steps/s over 7 blocks after a warm-up (block "
        f"seconds {', '.join(f'{t:.3f}' for t in af.block_seconds)})")
    del af
    # 16 walkers with injected draws: the card's complex64 against the
    # host's complex128, tau_bp = tau_max = 0.1 so that 2 blocks of 10
    # steps hold two measurements of each.
    g_gen = np.load(os.path.join(ROOT, "tests", "data",
                                 "generic_nmo11.npz"))

    def golden_generic_ham(device, dtype):
        n = g_gen["h1e"].shape[-1]
        return make_generic((3, 3), np.stack([g_gen["h1e"], g_gen["h1e"]]),
                            np.asarray(g_gen["chol"]).reshape(-1, n, n)
                            .transpose(1, 2, 0), ecore=float(g_gen["enuc"]),
                            device=device, dtype=dtype)

    small = {"mixed": {"energy_eval_freq": 1},
             "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True},
             "itcf": {"tau_max": 0.1, "stable": True}}
    sq = dict(nwalkers=16, dt=0.01, nsteps=10, nblocks=2, nstblz=5,
              npop_control=1, rng_seed=8)

    def small_af(device, dtype, popts, eopts, model="hubbard"):
        if model == "hubbard":
            ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device=device,
                               dtype=dtype)
            trial = free_electron_trial(ham, device=device, dtype=dtype)
        else:
            ham = golden_generic_ham(device, dtype)
            trial = trial_from_orbitals(ham, np.asarray(g_gen["psi"]),
                                        device=device, dtype=dtype)
        return AFQMC(ham, trial, QMCOpts(**sq), propagator_options=popts,
                     estimator_options=eopts, device=device)

    def card_vs_host(popts, eopts, xi, model="hubbard", nblocks=2):
        zero_counts()
        c = extras_blocks(small_af("cuda", "single", popts, eopts, model),
                          xi, pop16, nblocks, run_block, BlockNoise)
        launched = counts()
        h = extras_blocks(small_af("cpu", "double", popts, eopts, model),
                          xi, pop16, nblocks, run_block, BlockNoise)
        gaps = extras_gap(c, h)
        if not (all(np.isfinite(a).all() for b in c for a in b)
                and max(gaps) <= 1e-4):
            raise AssertionError(f"card vs host {popts} {eopts}: gaps "
                                 f"(mixed, BP, ITCF) {gaps} > 1e-4")
        return gaps, launched

    draws = np.random.default_rng(13)
    pop16 = draws.uniform(size=(40, 1))
    gaps13, _ = card_vs_host(discrete, small,
                             draws.uniform(size=(20, 16, 16)))
    say("13 BP + ITCF", f"16 walkers, 2 blocks with injected draws (tau_bp "
        f"= tau_max = 0.1): complex64 on the card vs complex128 on the host,"
        f" max |d| over the scale (mixed, BP, ITCF) "
        f"{', '.join(f'{x:.2e}' for x in gaps13)} <= 1e-4" + lap("13"))

    # ---- 14. the 3x3 tutorial anchors on the card ------------------------
    zero_counts()
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02],
                       device="cuda", dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    tut = AFQMC(ham, trial, QMCOpts(nwalkers=100, dt=0.05, nsteps=10,
                                    nblocks=300, nstblz=5, npop_control=10,
                                    rng_seed=8),
                propagator_options=discrete,
                estimator_options={
                    "mixed": {"energy_eval_freq": 10},
                    "back_propagation": {"tau_bp": 2.0,
                                         "evaluate_energy": True},
                    "itcf": {"tau_max": 2.0, "stable": True}},
                device="cuda")
    if tut.prop.sweep_kernel != "scan":
        raise AssertionError("the twisted tutorial lattice takes the scan "
                             "sweep")
    rows = tut.run()
    torch.cuda.synchronize()
    tut_counts = counts()
    want = only(**discrete_schedule(3000, 5, 10, 40, 40, True, False))
    if tut_counts != want:
        raise AssertionError(f"tutorial launches {tut_counts}, want {want}")
    et = rows[40:, 5].real
    blk = et[: len(et) // 10 * 10].reshape(-1, 10).mean(axis=1)
    se_m = blk.std(ddof=1) / len(blk) ** 0.5
    ebp = np.array([r["energies_40"][0].real for r in tut.bp_reporter.rows
                    if "energies_40" in r])[4:]
    se_bp = ebp.std(ddof=1) / len(ebp) ** 0.5
    live = np.array([r["real_space_greens_function"]
                     for r in tut.itcf_reporter.rows])
    live = live[np.abs(live[:, 0, 0, 0, 0, 0]) > 1e-12]
    g0, g9 = live[4:, 0, 0, 0, 0, 0], live[4:, 18, 0, 0, 0, 0]
    se_g = g0.std(ddof=1) / len(g0) ** 0.5
    anchors = {
        "mixed": (et.mean(), -9.667367, np.hypot(se_m, 0.006009)),
        "BP": (ebp.mean(), -10.172595, np.hypot(se_bp, 0.221067)),
        "ITCF G>up00(0)": (g0.mean(), 0.662088, np.hypot(se_g, 0.043912)),
    }
    missed = {k: v for k, v in anchors.items()
              if not abs(v[0] - v[1]) < 4 * v[2]}
    if (missed or len(live) < 40 or not abs(g9.mean() - 0.14) < 0.05
            or not np.isfinite(rows).all()):
        raise AssertionError(f"tutorial anchors missed: {missed}, "
                             f"{len(live)} ITCF rows, G(0.9) {g9.mean()}")
    tut_s = sum(tut.block_seconds)
    say("14 tutorial", "3x3 U=4 (3,3) twist [0.01,-0.02] discrete CPMC "
        "(scan sweep), dt=0.05, 100 walkers, 300 blocks, complex64, "
        "BP tau_bp=2.0 and ITCF tau_max=2.0: " + "; ".join(
            f"{k} {v[0]:.6f} vs published {v[1]:.6f}, |d| "
            f"{abs(v[0] - v[1]):.6f} < 4 x {v[2]:.6f}"
            for k, v in anchors.items())
        + f"; ITCF G>up00(0.9) {g9.mean():.4f} within 0.05 of 0.14 "
        f"({len(live)} measurements, {len(ebp) + 4} BP); launches "
        f"{tut_counts} as scheduled; {tut_s:.1f} s of blocks"
        + lap("14"))
    del tut

    # ---- 15. free projection, the direct update, k-space kinetic ---------
    fq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=3, nstblz=10,
                 npop_control=1, rng_seed=8)
    fsteps = fq.nblocks * fq.nsteps
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    ortho = 4 * (fsteps // fq.nstblz)
    modes = {
        "continuous free projection": ({"free_projection": True},
                                       only(inv_logdet_lanes=2 + 4 * fsteps,
                                            chol_inv_lanes=ortho)),
        "discrete free projection": (
            {**discrete, "free_projection": True},
            only(inv_logdet_lanes=2 + 4 * fsteps, chol_inv_lanes=ortho)),
        "direct update": ({**discrete, "single_site_update": False},
                          only(inv_logdet_lanes=2 + 10 * fsteps,
                               chol_inv_lanes=ortho)),
        "kinetic_kspace": ({**discrete, "kinetic_kspace": True},
                           only(inv_logdet_lanes=2 + 8 * fsteps,
                                chol_inv_lanes=ortho,
                                hirsch_sweep=fsteps)),
    }
    fp_counts = dict.fromkeys(counts(), 0)
    notes = []
    for name, (popts, want) in modes.items():
        zero_counts()
        af = AFQMC(ham, trial, fq, propagator_options=popts,
                   estimator_options=eopts, device="cuda")
        rows = af.run()
        torch.cuda.synchronize()
        got = counts()
        if got != want:
            raise AssertionError(f"{name} launches {got}, want {want}")
        for k, v in got.items():
            fp_counts[k] += v
        phase_gap = float((af.state.phase.abs() - 1).abs().max())
        if not (np.isfinite(rows).all() and phase_gap <= 1e-5):
            raise AssertionError(f"{name}: rows {rows}, |phase| - 1 "
                                 f"{phase_gap}")
        et_rows = np.array2string(rows[:, 5], precision=3)
        notes.append(f"{name} ETotal {et_rows} (|phase| - 1 <= "
                     f"{phase_gap:.1e})")
        del af
    # Hubbard continuous with BP: the [w, M, n] block, not the lanes one.
    zero_counts()
    af = AFQMC(ham, trial, QMCOpts(nwalkers=1024, dt=0.01, nsteps=10,
                                   nblocks=2, nstblz=5, npop_control=1,
                                   rng_seed=8),
               estimator_options={"mixed": {"energy_eval_freq": 1},
                                  "back_propagation": {
                                      "tau_bp": 0.1,
                                      "evaluate_energy": True}},
               device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    got = counts()
    want = only(inv_logdet_lanes=2 + 6 * 20 + 2 * 2,
                chol_inv_lanes=4 * 4 + 2 * 2 * orthos(10, 5))
    bpc = [r["energies_10"] for r in af.bp_reporter.rows]
    if af.use_fast_block or got != want or not (
            np.isfinite(rows).all() and np.isfinite(bpc).all()):
        raise AssertionError(f"continuous BP launches {got}, want {want}; "
                             f"BP {bpc}")
    for k, v in got.items():
        fp_counts[k] += v
    notes.append(f"continuous BP (tau_bp=0.1, [w, M, n] block) BP energies "
                 f"{[round(float(e[0].real), 4) for e in bpc]}")
    del af
    gaps15 = {
        "continuous free projection": card_vs_host(
            {"free_projection": True}, None,
            draws.normal(size=(20, 16, 16)))[0],
        "discrete free projection": card_vs_host(
            {**discrete, "free_projection": True}, None,
            (draws.uniform(size=(20, 16, 16)) < 0.5).astype(float))[0],
        "direct update": card_vs_host(
            {**discrete, "single_site_update": False}, None,
            draws.uniform(size=(20, 16, 16)))[0],
        "kinetic_kspace": card_vs_host(
            {**discrete, "kinetic_kspace": True}, None,
            draws.uniform(size=(20, 16, 16)))[0],
        "hybrid=False": card_vs_host({"hybrid": False}, None,
                                     draws.normal(size=(20, 16, 16)))[0],
        "continuous BP partial": card_vs_host(
            None, {"mixed": {"energy_eval_freq": 1},
                   "back_propagation": {"tau_bp": 0.1,
                                        "restore_weights": "partial"}},
            draws.normal(size=(20, 16, 16)))[0],
    }
    say("15 run modes", f"4x4 (7,7) U=4 complex64 1024 walkers {fsteps} "
        f"steps each: " + "; ".join(notes) + f"; launches {fp_counts} as "
        "scheduled; 16 walkers, 2 blocks with injected draws, complex64 on "
        "the card vs complex128 on the host, max |d| over the scale "
        "(mixed, BP): " + "; ".join(
            f"{k} {v[0]:.2e}, {v[1]:.2e}" for k, v in gaps15.items())
        + " (<= 1e-4)" + lap("15"))

    # ---- 16. Generic BP + EKT --------------------------------------------
    gen_bp = {"mixed": {"energy_eval_freq": 1},
              "back_propagation": {"tau_bp": 0.05, "evaluate_energy": True,
                                   "evaluate_ekt": True}}
    xg = draws.normal(size=(30, 16, g_gen["chol"].shape[0]))
    sq["nwalkers"], sq["dt"], sq["nstblz"] = 16, 0.005, 5
    gaps16, gold_counts = card_vs_host(pallas, gen_bp, xg, model="generic",
                                       nblocks=3)
    if gold_counts["taylor_exp"] != 30 + 3 * 10:
        raise AssertionError(f"Generic golden BP launches {gold_counts}")
    zero_counts()
    ham = generic_model(128, 512, 16, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, QMCOpts(nwalkers=1024, dt=0.005, nsteps=10,
                                   nblocks=1, nstblz=5, npop_control=1,
                                   rng_seed=8),
               propagator_options=pallas,
               estimator_options={"mixed": {"energy_eval_freq": 1},
                                  "back_propagation": {
                                      "tau_bp": 0.05,
                                      "evaluate_energy": True}},
               device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    bpg_counts = counts()
    want = only(taylor_exp=10 + 10, inv_logdet_lanes=2 + 6 * 10 + 2,
                chol_inv_lanes=4 * 2 + 2 * orthos(10, 5))
    r = af.bp_reporter.rows[0]
    tr_g = [float(np.trace(r["one_rdm_10"][s]).real
                  / r["denominator_10"][0].real) for s in (0, 1)]
    if not (bpg_counts == want and np.isfinite(rows).all()
            and np.isfinite(r["energies_10"]).all()
            and max(abs(x / 16.0 - 1.0) for x in tr_g) <= 1e-4):
        raise AssertionError(f"Generic BP at the bench shape: launches "
                             f"{bpg_counts} (want {want}), Tr G {tr_g}, "
                             f"energies {r['energies_10']}")
    say("16 Generic BP", f"golden nmo=11 (3,3), 16 walkers, 3 blocks with "
        f"injected draws, BP tau_bp=0.05 with energies and EKT, "
        f"taylor_impl=pallas: complex64 on the card (launches {gold_counts})"
        f" vs complex128 on the host, max |d| over the scale (mixed, BP) "
        f"{gaps16[0]:.2e}, {gaps16[1]:.2e} <= 1e-4; bench shape nmo=128 "
        f"naux=512 (16,16) 1024 walkers, one BP measurement of tau_bp=0.05:"
        f" BP energy {r['energies_10'][0].real:.5f} (mixed ETotal "
        f"{rows[0, 5].real:.5f}), Tr G_bp per spin "
        f"{', '.join(f'{x:.5f}' for x in tr_g)} = 16, launches "
        f"{bpg_counts} as scheduled (Taylor 10 forward + 10 back); block "
        f"{af.block_seconds[0]:.2f} s" + lap("16"))
    del ham, trial, af

    # ---- 17. low-rank thermal UEG at the bench shape ---------------------
    lr_opts = {"walker_options": {"low_rank": True, "low_rank_thresh": 1e-6}}
    zero_counts()
    af = thermal_ueg("cuda", "single", 256, 2, **lr_opts)
    rows = af.run()
    torch.cuda.synchronize()
    lr_counts = counts()
    if not (np.isfinite(rows).all() and (rows[:, 10].real > 0).all()):
        raise AssertionError(f"low-rank thermal UEG rows {rows}")
    ncpqr, nkb = low_rank_launches(af.ntime_slices, af.trial.stack_size,
                                   af.qmc.nblocks)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if lr_counts != want:
        raise AssertionError(f"low-rank thermal UEG launches {lr_counts}, "
                             f"want {want}")
    timed = af.block_seconds[1:]
    rate_lr = af.qmc.nwalkers * af.ntime_slices * len(timed) / sum(timed)
    say("17 low-rank UEG", f"phase 11's system with walker_options "
        f"low_rank, thresh 1e-6: ETotal per row "
        f"{np.array2string(rows[:, 5].real, precision=5)}, Nav "
        f"{np.array2string(rows[:, 10].real, precision=5)}; launches "
        f"{lr_counts}; {rate_lr:.1f} walker-slice-steps/s over "
        f"{len(timed)} path(s) after a warm-up path (path seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)}), beside "
        f"phase 11's full-rank {rate_t:.1f} in this run")
    # Card (complex64) against host (complex128), one path of 16 walkers
    # with the same injected draws; the limit as phase 11's.
    xi = draws.normal(size=(af.ntime_slices, 16, af.prop.nfields))
    pop = draws.uniform(size=(af.ntime_slices, 1))
    del af
    card = thermal_injected(thermal_ueg("cuda", "single", 16, 1, **lr_opts),
                            xi, pop, PathNoise)
    host = thermal_injected(thermal_ueg("cpu", "double", 16, 1, **lr_opts),
                            xi, pop, PathNoise)
    d_e = abs(card[5] - host[5]) / abs(host[5])
    d_n = abs(card[10] - host[10]) / abs(host[10])
    if not (np.isfinite(card).all() and d_e <= 1e-4 and d_n <= 1e-4):
        raise AssertionError(f"low-rank UEG: complex64 on the card {card} "
                             f"vs complex128 on the host {host}: dE "
                             f"{d_e:.3e}, dNav {d_n:.3e} > 1e-4")
    # The anchor tests/data/thermal_ueg_lowrank.npz (the JAX package's
    # test settings: nup = ndown = 1, ecut = 4, M = 93, the system's mu
    # 0.245 in the sampled slices, the trial's bisected, beta = 0.5, 16
    # walkers, seed 8), 160 paths in complex64.
    ga = np.load(os.path.join(ROOT, "tests", "data",
                              "thermal_ueg_lowrank.npz"))
    ham = make_ueg(1, 1, rs=1.0, ecut=4.0, device="cuda", dtype="single")
    trial = make_one_body_trial(ham, 0.5, 0.05, device="cuda",
                                dtype="single")
    af = ThermalAFQMC(ham, trial, QMCOpts(
        nwalkers=16, dt=0.05, nsteps=1, nblocks=160, beta=0.5, rng_seed=8),
        propagator_options={"mu": float(ga["mu"])}, device="cuda",
        **lr_opts)
    rows = af.run()
    r0 = (abs(rows[0, 5].real / 5.97385568 - 1),
          abs(rows[0, 10].real / 1.99999991 - 1))
    et, nav = rows[1:, 5].real, rows[1:, 10].real
    ref_e, ref_n = np.asarray(ga["etotal"])[1:], np.asarray(ga["nav"])[1:]
    se_e = float(np.hypot(et.std(ddof=1) / np.sqrt(len(et)),
                          ref_e.std(ddof=1) / np.sqrt(len(ref_e))))
    se_n = float(np.hypot(nav.std(ddof=1) / np.sqrt(len(nav)),
                          ref_n.std(ddof=1) / np.sqrt(len(ref_n))))
    de, dn = abs(et.mean() - ref_e.mean()), abs(nav.mean() - ref_n.mean())
    if not (ham.nbasis == 93 and np.isfinite(rows).all()
            and max(r0) <= 1e-5 and de < 4 * se_e and dn < 4 * se_n):
        raise AssertionError(f"low-rank UEG anchor: row 0 {rows[0, 5]} / "
                             f"{rows[0, 10]}; E {et.mean()} vs "
                             f"{ref_e.mean()} (se {se_e}), Nav {nav.mean()} "
                             f"vs {ref_n.mean()} (se {se_n})")
    say("17 low-rank UEG", f"16 walkers, one path with injected draws: "
        f"complex64 on the card ETotal {card[5].real:.6f} Nav "
        f"{card[10].real:.6f} vs complex128 on the host {host[5].real:.6f}"
        f" / {host[10].real:.6f}: relative {d_e:.3e} / {d_n:.3e} <= 1e-4; "
        f"anchor thermal_ueg_lowrank.npz (M=93, 16 walkers, 160 paths, "
        f"complex64): row 0 ETotal {rows[0, 5].real:.8f} Nav "
        f"{rows[0, 10].real:.8f} (relative {r0[0]:.2e} / {r0[1]:.2e} <= "
        f"1e-5); E {et.mean():.6f} vs reference {ref_e.mean():.6f}, |d| "
        f"{de:.6f} < 4 se {4 * se_e:.6f}; Nav {nav.mean():.6f} vs "
        f"{ref_n.mean():.6f}, |d| {dn:.6f} < 4 se {4 * se_n:.6f}; "
        f"{sum(af.block_seconds):.2f} s of paths" + lap("17"))
    del ham, trial, af

    # ---- 18. discrete thermal Hubbard ------------------------------------
    def discrete_hubbard(device, dtype, nwalkers, nblocks, beta=2.0, U=4.0,
                         **popts):
        ham = make_hubbard(3, 3, U=U, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_one_body_trial(ham, beta, 0.05, mu=0.9, device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=nwalkers, dt=0.05, nsteps=1, nblocks=nblocks,
            beta=beta, npop_control=2, rng_seed=8),
            propagator_options={"hubbard_stratonovich": "discrete",
                                **popts}, device=device)

    zero_counts()
    af = discrete_hubbard("cuda", "single", 128, 2)
    rows = af.run()
    torch.cuda.synchronize()
    td_counts = counts()
    nbins, ss, ns = af.trial.nbins, af.trial.stack_size, af.ntime_slices
    ncpqr, nkb = discrete_thermal_launches(nbins, ss, ns, 2)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if not (np.isfinite(rows).all() and td_counts == want):
        raise AssertionError(f"discrete thermal rows {rows}, launches "
                             f"{td_counts} (want {want})")
    td_line = (f"3x3 U=4 mu=0.9 beta=2 dt=0.05 ({ns} slices, {nbins} bins "
               f"of {ss}) complex64 128 walkers, pop control every 2: "
               f"ETotal {np.array2string(rows[:, 5].real, precision=5)}, "
               f"Nav {np.array2string(rows[:, 10].real, precision=5)}; "
               f"launches {td_counts}; path seconds "
               f"{', '.join(f'{t:.4f}' for t in af.block_seconds)}")
    # Card vs host, 16 walkers, 2 paths: the heat-bath uniforms [M, w] of
    # each slice (constrained path) or the fields [w, M] (free projection).
    gaps18 = []
    for fp in (False, True):
        card_af = discrete_hubbard("cuda", "single", 16, 2,
                                   free_projection=fp)
        host_af = discrete_hubbard("cpu", "double", 16, 2,
                                   free_projection=fp)
        pairs = []
        for _ in range(2):
            if fp:
                xi = (draws.uniform(size=(ns, 16, 9)) < 0.5).astype(float)
            else:
                xi = draws.uniform(size=(ns, 9, 16))
            pop = draws.uniform(size=(ns, 1))
            c = thermal_injected(card_af, xi, pop, PathNoise)
            h = thermal_injected(host_af, xi, pop, PathNoise)
            pairs.append([c[5].real, h[5].real, c[10].real, h[10].real])
        pairs = np.array(pairs)
        gap = max(np.abs(pairs[:, 0] - pairs[:, 1]).max()
                  / np.abs(pairs[:, 1]).max(),
                  np.abs(pairs[:, 2] - pairs[:, 3]).max()
                  / np.abs(pairs[:, 3]).max())
        if not (np.isfinite(pairs).all() and gap <= 1e-4):
            raise AssertionError(f"discrete thermal (free projection {fp}):"
                                 f" card vs host {pairs}")
        gaps18.append(gap)
    # The wrapped G (recomputed at bin boundaries only) against a
    # recompute every slice, slice by slice with the same uniforms, in
    # complex128: the wrap is an exact similarity transform, and in
    # complex64 twenty chained wraps compound float32 rounding.
    wraps = [discrete_hubbard("cuda", "double", 16, 1, wrap_stabilize=k)
             for k in (1, 10 ** 9)]
    states = [a.state for a in wraps]
    wrap_gap = 0.0
    for ts in range(ns):
        rs = torch.from_numpy(draws.uniform(size=(9, 16))).to("cuda")
        states = [a.prop.propagate(a.trial, st, ts, rs)
                  for a, st in zip(wraps, states)]
        g_ref = states[0].G
        wrap_gap = max(wrap_gap, ((states[1].G - g_ref).abs().max()
                                  / g_ref.abs().max()).item(),
                       ((states[1].weight - states[0].weight).abs().max()
                        / states[0].weight.abs().max()).item())
    if wrap_gap > 1e-8:
        raise AssertionError(f"discrete thermal wrap vs recompute "
                             f"{wrap_gap:.3e} > 1e-8")
    # U = 0: every row the exact grand-canonical E and N (16 walkers: the
    # weights stay 1, under the 10% cap).
    free = []
    for beta, dtype, tol_e, tol_n in ((2.0, "single", 1e-4, 1e-4),
                                      (16.0, "double", 1e-4, 1e-5)):
        af = discrete_hubbard("cuda", dtype, 16, 1, beta=beta, U=0.0)
        rows = af.run()
        evals = np.linalg.eigvalsh(af.ham.T[0].cpu().double().numpy())
        occ = 1.0 / (np.exp(beta * (evals - af.trial.mu)) + 1.0)
        e_x, n_x = 2 * np.sum(evals * occ), 2 * occ.sum()
        gap = (np.abs(rows[:, 5].real - e_x).max(),
               np.abs(rows[:, 10].real - n_x).max())
        if not (gap[0] <= tol_e and gap[1] <= tol_n):
            raise AssertionError(f"discrete thermal U=0 beta={beta}: rows "
                                 f"{rows[:, [5, 10]]} vs exact {e_x}, "
                                 f"{n_x}")
        free.append(f"beta={beta:g} {dtype} |dE| {gap[0]:.2e} |dN| "
                    f"{gap[1]:.2e}")
    # The 2-site open chain against grand-canonical ED.
    ham = make_hubbard(1, 1, U=4.0, nx=2, ny=1, xpbc=False, device="cuda",
                       dtype="single")
    trial = make_one_body_trial(ham, 1.0, 0.025, mu=1.0, device="cuda",
                                dtype="single")
    af = ThermalAFQMC(ham, trial, QMCOpts(
        nwalkers=256, dt=0.025, nsteps=1, nblocks=48, beta=1.0,
        npop_control=5, rng_seed=11),
        propagator_options={"hubbard_stratonovich": "discrete"},
        device="cuda")
    rows = af.run()
    e_ed, n_ed = exact_grand_canonical_hubbard_2site(4.0, 1.0, 1.0, 1.0)
    et, nav = rows[1:, 5].real, rows[1:, 10].real
    se = float(et.std(ddof=1) / np.sqrt(len(et)))
    if not (np.isfinite(rows).all() and abs(et.mean() - e_ed)
            < max(4 * se, 0.05) and abs(nav.mean() - n_ed) < 0.05):
        raise AssertionError(f"2-site ED anchor: E {et.mean()} vs {e_ed} "
                             f"(se {se}), N {nav.mean()} vs {n_ed}")
    say("18 discrete thermal", td_line + f"; 16 walkers, 2 paths with "
        f"injected draws, card (complex64) vs host (complex128), max |d| "
        f"over the scale: constrained path {gaps18[0]:.2e}, free "
        f"projection {gaps18[1]:.2e} <= 1e-4; wrap_stabilize=1e9 vs 1, "
        f"{ns} slices, complex128: max |dG|, |dw| over the scale "
        f"{wrap_gap:.2e} <= 1e-8; U=0 exact on every row: "
        f"{'; '.join(free)}; 2-site U=4 ED anchor (256 walkers, 48 "
        f"paths, complex64): E {et.mean():.6f} vs ED {e_ed:.6f} (|d| "
        f"{abs(et.mean() - e_ed):.6f} < max(4 se, 0.05), se {se:.6f}), "
        f"N {nav.mean():.6f} vs {n_ed:.6f}"
        + lap("18"))
    del ham, trial, af, card_af, host_af, wraps, states

    # ---- 19. the Generic thermal inner -----------------------------------
    zero_counts()
    ham = generic_model(128, 512, 16, make_generic)
    trial = make_one_body_trial(ham, 0.5, 0.05, device="cuda",
                                dtype="single")
    af = ThermalAFQMC(ham, trial, QMCOpts(
        nwalkers=64, dt=0.05, nsteps=1, nblocks=1, beta=0.5,
        npop_control=1, rng_seed=8), device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    tg_counts = counts()
    tnb, tss = af.trial.nbins, af.trial.stack_size
    ncpqr, nkb = thermal_launches(tnb, tss, af.ntime_slices, 1)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if not (np.isfinite(rows).all() and (rows[:, 10].real > 0).all()
            and tg_counts == want):
        raise AssertionError(f"Generic thermal rows {rows}, launches "
                             f"{tg_counts} (want {want})")
    tg_line = (f"bench shape nmo=128 naux=512 (16,16) beta=0.5 dt=0.05 "
               f"({af.ntime_slices} slices, {tnb} bins of {tss}) complex64 "
               f"64 walkers: ETotal "
               f"{np.array2string(rows[:, 5].real, precision=5)}, Nav "
               f"{np.array2string(rows[:, 10].real, precision=5)}; launches "
               f"{tg_counts}; path {af.block_seconds[0]:.4f} s")
    del ham, trial, af

    def generic_thermal(device, dtype):
        ham = golden_generic_ham(device, dtype)
        trial = make_one_body_trial(ham, 0.5, 0.05, device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=16, dt=0.05, nsteps=1, nblocks=1, beta=0.5,
            npop_control=1, rng_seed=8), device=device)

    xi = draws.normal(size=(10, 16, g_gen["chol"].shape[0]))
    pop = draws.uniform(size=(10, 1))
    card = thermal_injected(generic_thermal("cuda", "single"), xi, pop,
                            PathNoise)
    host = thermal_injected(generic_thermal("cpu", "double"), xi, pop,
                            PathNoise)
    d_e = abs(card[5] - host[5]) / abs(host[5])
    d_n = abs(card[10] - host[10]) / abs(host[10])
    if not (np.isfinite(card).all() and d_e <= 1e-4 and d_n <= 1e-4):
        raise AssertionError(f"Generic thermal: card {card} vs host {host}")
    say("19 Generic thermal", tg_line + f"; generic_nmo11.npz's "
        f"Hamiltonian beta=0.5, 16 walkers, one path with injected draws: "
        f"complex64 on the card ETotal {card[5].real:.6f} Nav "
        f"{card[10].real:.6f} vs complex128 on the host "
        f"{host[5].real:.6f} / {host[10].real:.6f}: relative {d_e:.3e} / "
        f"{d_n:.3e} <= 1e-4" + lap("19"))

    # ---- 20. the mean-field trial and average_gf -------------------------
    def thf(device, dtype, nwalkers, nblocks):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_mean_field_trial(ham, 1.0, 0.05, nav=6.0,
                                      device=device, dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=nwalkers, dt=0.05, nsteps=1, nblocks=nblocks, beta=1.0,
            npop_control=2, rng_seed=8), propagator_options={"mu": 0.9},
            device=device)

    zero_counts()
    af = thf("cuda", "single", 128, 2)
    rows = af.run()
    torch.cuda.synchronize()
    mf_counts = counts()
    ncpqr, nkb = thermal_launches(af.trial.nbins, af.trial.stack_size,
                                  af.ntime_slices, 2)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if not (np.isfinite(rows).all() and abs(af.trial.nav - 6.0) <= 1e-3
            and af.trial.name == "mean_field" and mf_counts == want):
        raise AssertionError(f"mean-field trial: nav {af.trial.nav}, rows "
                             f"{rows}, launches {mf_counts} (want {want})")
    mf_line = (f"THF trial 3x3 U=4 beta=1 nav=6 (mu {af.trial.mu:.6f}, Nav "
               f"{af.trial.nav:.6f}), system mu 0.9, complex64 128 "
               f"walkers: ETotal "
               f"{np.array2string(rows[:, 5].real, precision=5)}, Nav "
               f"{np.array2string(rows[:, 10].real, precision=5)}; launches "
               f"{mf_counts}")
    xi = draws.normal(size=(af.ntime_slices, 16, 9))
    pop = draws.uniform(size=(af.ntime_slices, 1))
    card = thermal_injected(thf("cuda", "single", 16, 1), xi, pop,
                            PathNoise)
    host = thermal_injected(thf("cpu", "double", 16, 1), xi, pop,
                            PathNoise)
    gap_mf = max(abs(card[5] - host[5]) / abs(host[5]),
                 abs(card[10] - host[10]) / abs(host[10]))
    if not (np.isfinite(card).all() and gap_mf <= 1e-4):
        raise AssertionError(f"mean-field trial: card {card} vs host {host}")
    # average_gf on phase 12's full-rank path in 5 bins of 2 (so that the
    # average runs over 5 origins): one path through run() on the card (its
    # launches: the path's and, at the two measurements, G at every stack
    # origin), then card vs host with injected draws.
    avg_opts = {"estimator_options": {"mixed": {"average_gf": True}}}

    def averaged(device, dtype, nblocks):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_one_body_trial(ham, tbeta, tdt, mu=float(g["mu"]),
                                    stack_size=2, device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=tnw, dt=tdt, nsteps=1, nblocks=nblocks, beta=tbeta,
            npop_control=2, rng_seed=8), device=device, **avg_opts)

    zero_counts()
    af = averaged("cuda", "single", 1)
    rows = af.run()
    torch.cuda.synchronize()
    avg_counts = counts()
    anb, ass = af.trial.nbins, af.trial.stack_size
    path = thermal_launches(anb, ass, af.ntime_slices, 1)
    extra = average_gf_launches(anb, 2)
    want = only(cpqr=path[0] + extra[0],
                inv_logdet_lanes=path[1] + extra[1])
    if not (np.isfinite(rows).all() and avg_counts == want):
        raise AssertionError(f"average_gf rows {rows}, launches "
                             f"{avg_counts} (want {want})")
    xi = draws.normal(size=(af.ntime_slices, tnw, 9))
    pop = draws.uniform(size=(af.ntime_slices, 1))
    card = thermal_injected(averaged("cuda", "single", 1), xi, pop,
                            PathNoise)
    host = thermal_injected(averaged("cpu", "double", 1), xi, pop,
                            PathNoise)
    gap_avg = max(abs(card[5] - host[5]) / abs(host[5]),
                  abs(card[10] - host[10]) / abs(host[10]))
    if not (np.isfinite(card).all() and gap_avg <= 1e-4):
        raise AssertionError(f"average_gf: card {card} vs host {host}")
    try:
        thermal_ueg("cuda", "single", 2, 1, **lr_opts, **avg_opts)
    except NotImplementedError as refusal:
        refused = str(refusal)
    else:
        raise AssertionError("low-rank with average_gf was not refused")
    say("20 THF + average_gf", mf_line + f"; 16 walkers, one path with "
        f"injected draws, card (complex64) vs host (complex128): relative "
        f"{gap_mf:.3e} <= 1e-4; average_gf on phase 12's system ({anb} "
        f"bins of {ass}, {tnw} walkers): launches {avg_counts} (the path's "
        f"and {extra[0]} cpqr + {extra[1]} kernel B for G at every origin "
        f"of the 2 measurements), card vs host one path with injected "
        f"draws: relative {gap_avg:.3e} <= 1e-4; low-rank with average_gf "
        f"refused ({refused})" + lap("20"))
    del af
    # ---- 21. the UEG at the bench shape ----------------------------------
    # bench.py:492-520's UEG class: (7, 7), rs=1, ecut=8 (M=257, 2108 q
    # vectors, 4216 fields), RHF-identity trial, complex64, 512 walkers,
    # dt=0.005, re-orthogonalisation every 5 steps, population control
    # every step, the energy every 10; one warm-up block and 3 timed, in
    # the float32 ("pallas") and the bf16 ("pallas_bf16") Taylor tier.
    tiers = (("pallas", ("taylor_exp",)),
             ("pallas_bf16", ("taylor_bf16", "taylor_bf16_resident")))

    def set_tier(impl: str) -> None:
        os.environ["PAUXY_TPU_TAYLOR_UEG"] = impl

    uq = QMCOpts(nwalkers=512, dt=0.005, nsteps=10, nblocks=4, nstblz=5,
                 npop_control=1, rng_seed=8)
    usteps = uq.nblocks * uq.nsteps
    ham = make_ueg(7, 7, rs=1.0, ecut=8.0, device="cuda", dtype="single")
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    if (ham.nbasis, ham.nq, ham.nfields, ham.qmesh) != (257, 2108, 4216,
                                                         (17, 17, 17)):
        raise AssertionError(f"UEG bench shape {ham.nbasis} {ham.nq} "
                             f"{ham.qmesh}")
    ueg_tier, ueg_rates, ueg_e = {}, {}, {}
    for impl, keys in tiers:
        set_tier(impl)
        zero_counts()
        af = AFQMC(ham, trial, uq,
                   estimator_options={"mixed": {"energy_eval_freq": 10}},
                   device="cuda")
        if af.prop.inner.taylor_impl != impl:
            raise AssertionError(f"UEG tier {af.prop.inner.taylor_impl}")
        rows = af.run()
        torch.cuda.synchronize()
        ueg_tier[impl] = counts()
        # Per step: the Taylor kernel and the plane-wave force-bias kernel
        # once; kernel B 2 for the Green's functions and 2 for the new
        # overlaps, 2 per energy; 2 at set-up. Cholesky: 2 spins x 2
        # passes a re-orthogonalisation.
        want = only(**dict.fromkeys(keys, usteps), pw_force_bias=usteps,
                    inv_logdet_lanes=2 + 4 * usteps + 2 * (usteps // 10),
                    chol_inv_lanes=4 * (usteps // uq.nstblz))
        if ueg_tier[impl] != want:
            raise AssertionError(f"UEG {impl} launches {ueg_tier[impl]}, "
                                 f"want {want}")
        if not (np.isfinite(rows.real).all()
                and bool(torch.isfinite(af.state.weight).all())):
            raise AssertionError(f"UEG {impl}: non-finite rows {rows}")
        timed = af.block_seconds[1:]
        ueg_rates[impl] = uq.nwalkers * uq.nsteps * len(timed) / sum(timed)
        ueg_e[impl] = (rows[:, 5].real, af.block_seconds)
    planewave_counts = {k: sum(c[k] for c in ueg_tier.values())
                        for k in counts()}
    del af
    say("21 UEG path", f"(7,7) rs=1 ecut=8: M={ham.nbasis} nq={ham.nq} "
        f"fields={ham.nfields} cube {ham.qmesh}, RHF trial (etrial "
        f"{trial.etrial:.6f}), complex64 {uq.nwalkers} walkers {usteps} "
        "steps: " + "; ".join(
            f"{impl}: ETotal per block "
            f"{np.array2string(ueg_e[impl][0], precision=5)}, launches "
            f"{ueg_tier[impl]}, {ueg_rates[impl]:.1f} walker-steps/s over 3 "
            f"blocks after a warm-up block (block seconds "
            f"{', '.join(f'{t:.4f}' for t in ueg_e[impl][1])})"
            for impl, _ in tiers))
    del ham, trial

    # The card's complex64 path (the float32 kernel) against the host's
    # complex128 "xla" path with the same injected draws: 16 walkers, 2
    # blocks, within 1e-4 of the block values' scale (float32 rounding).
    def ueg_small(device, dtype, impl, nblocks=2):
        set_tier(impl)
        h = make_ueg(7, 7, rs=1.0, ecut=8.0, device=device, dtype=dtype)
        t = rhf_identity_trial(h, device=device, dtype=dtype)
        return AFQMC(h, t, QMCOpts(nwalkers=16, dt=0.005, nsteps=10,
                                   nblocks=nblocks, nstblz=5,
                                   npop_control=1, rng_seed=8),
                     device=device)

    draws = np.random.default_rng(21)
    xi = draws.normal(size=(20, 16, 4216))
    pop = draws.uniform(size=(20, 1))
    zero_counts()
    card = injected_blocks(ueg_small("cuda", "single", "pallas"), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    inj_counts = counts()
    host = injected_blocks(ueg_small("cpu", "double", "xla"), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    gap_ueg = float((np.abs(card - host).max(axis=0)
                     / np.abs(host).max(axis=0)).max())
    if not (np.isfinite(card).all() and gap_ueg <= 1e-4
            and inj_counts["taylor_exp"] == 20
            and inj_counts["pw_force_bias"] == 20):
        raise AssertionError(f"UEG card vs host: {card.tolist()} vs "
                             f"{host.tolist()} ({gap_ueg:.3e}), launches "
                             f"{inj_counts}")
    say("21 UEG path", f"16 walkers, 2 blocks with injected draws: "
        f"complex64 on the card (pallas, launches {inj_counts}) vs "
        f"complex128 on the host (xla), block ETotal "
        f"{np.array2string(card[:, 0], precision=6)} vs "
        f"{np.array2string(host[:, 0], precision=6)}: max |d| over the "
        f"block values' scale {gap_ueg:.3e} <= 1e-4" + lap("21"))

    # ---- 22. the UEG golden anchor ---------------------------------------
    # tests/data/ueg_rs2.44_ecut2.npz (M=33, 40 walkers, 100 blocks of 10
    # steps, the energy every step) in complex64 on the card, in each tier;
    # tests/test_afqmc_driver.py:180-212's criterion |d| < max(4 se, 0.05)
    # over the last two thirds. The float32 tier must hold it; the bf16
    # tier's reading is its end-to-end validation, reported as it falls.
    g = np.load(os.path.join(ROOT, "tests", "data", "ueg_rs2.44_ecut2.npz"))

    def ueg_golden(device, dtype, impl, nwalkers=int(g["nwalkers"]),
                   nblocks=100, eopts=None):
        set_tier(impl)
        h = make_ueg(int(g["nup"]), int(g["ndown"]), rs=float(g["rs"]),
                     ecut=float(g["ecut"]), device=device, dtype=dtype)
        t = rhf_identity_trial(h, device=device, dtype=dtype)
        return AFQMC(h, t, QMCOpts(nwalkers=nwalkers, dt=float(g["dt"]),
                                   nsteps=int(g["nsteps"]), nblocks=nblocks,
                                   nstblz=10, npop_control=1, rng_seed=8),
                     estimator_options=eopts or {
                         "mixed": {"energy_eval_freq": 1}},
                     device=device)

    theirs = np.asarray(g["etotal_blocks"])[len(g["etotal_blocks"]) // 3:]
    gold, gold_tier = {}, {}
    for impl, keys in tiers:
        zero_counts()
        af = ueg_golden("cuda", "single", impl)
        if abs(af.trial.etrial - float(g["etrial"])) > 1e-5:
            raise AssertionError(f"UEG golden etrial {af.trial.etrial}")
        rows = af.run()
        torch.cuda.synchronize()
        gold_tier[impl] = counts()
        gsteps = 100 * int(g["nsteps"])
        want = only(**dict.fromkeys(keys, gsteps), pw_force_bias=gsteps,
                    inv_logdet_lanes=2 + 6 * gsteps,
                    chol_inv_lanes=4 * (gsteps // 10))
        et = rows[:, 5].real
        if gold_tier[impl] != want or not np.isfinite(et).all():
            raise AssertionError(f"UEG golden {impl}: launches "
                                 f"{gold_tier[impl]} (want {want}), {et}")
        mine = et[len(et) // 3:]
        se = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                            theirs.std(ddof=1) / np.sqrt(len(theirs))))
        diff = float(abs(mine.mean() - theirs.mean()))
        gold[impl] = (float(mine.mean()), diff, se,
                      diff < max(4 * se, 0.05))
    if not gold["pallas"][3]:
        raise AssertionError(f"UEG golden missed in the float32 tier: "
                             f"{gold['pallas']} vs {theirs.mean()}")
    say("22 UEG golden", f"rs=2.44 ecut=2 (7,7) M=33, 40 walkers, 100 "
        f"blocks, complex64, reference {theirs.mean():.6f}: " + "; ".join(
            f"{impl} port {m:.6f}, |diff| {d:.6f} "
            + ("<" if ok else "NOT <")
            + f" max(4 se, 0.05) = {max(4 * se, 0.05):.6f} (se {se:.6f}): "
            + ("holds" if ok else "MISSES")
            for impl, (m, d, se, ok) in gold.items()))

    # Back propagation with the structure factor on the golden system, 16
    # walkers, 2 blocks with injected draws (tau_bp = 0.05: 2 measurements
    # a block), card (pallas) against host (xla) within 1e-4 of the scale;
    # on the card the S(k) tail contracts with v_q to the BP two-body
    # energy.
    bp_sf = {"mixed": {"energy_eval_freq": 1},
             "back_propagation": {"tau_bp": 0.05, "evaluate_energy": True,
                                  "two_rdm": "structure_factor"}}
    probe = ueg_golden("cpu", "double", "xla", 16, 2, bp_sf)
    xi = draws.normal(size=(20, 16, probe.ham.nfields))
    pop = draws.uniform(size=(20, 1))
    zero_counts()
    card_af = ueg_golden("cuda", "single", "pallas", 16, 2, bp_sf)
    card = extras_blocks(card_af, xi, pop, 2, run_block, BlockNoise)
    bpsf_counts = counts()
    host = extras_blocks(probe, xi, pop, 2, run_block, BlockNoise)
    bp_gap = extras_gap(card, host)[1]
    # The mixed sums as phase 21 reads them (block ETotal and unscaled
    # weight): the hybrid-energy sum divides float32 log-overlap rounding
    # by dt = 0.01 (8.5e-5 of the scale between the host's complex64 and
    # complex128 runs), a reading of the step, not of the estimators.
    et_gap = max(
        max(abs(c[0][mixed.ENUMER] / c[0][mixed.EDENOM]
                - h[0][mixed.ENUMER] / h[0][mixed.EDENOM])
            / abs(h[0][mixed.ENUMER] / h[0][mixed.EDENOM]),
            abs(c[0][mixed.UWEIGHT] - h[0][mixed.UWEIGHT])
            / abs(h[0][mixed.UWEIGHT]))
        for c, h in zip(card, host))
    m33, nq33 = probe.ham.nbasis, probe.ham.nq
    vq = probe.ham.vqvec.numpy()
    e2_gap = 0.0
    for blk in card:
        a = blk[1]
        sk = a[4 + 2 * m33 * m33:].reshape(2, 2, nq33)
        pe = np.sum(vq * sk.sum(axis=(0, 1))) / (2 * probe.ham.vol)
        e2_gap = max(e2_gap, abs(pe - a[2]) / abs(a[2]))
    # Taylor: 20 forward steps and 4 measurements of 5 back steps.
    if not (max(bp_gap, et_gap) <= 1e-4 and e2_gap <= 1e-3
            and bpsf_counts["taylor_exp"] == 40):
        raise AssertionError(f"UEG BP structure factor: BP {bp_gap:.3e}, "
                             f"mixed {et_gap:.3e}, S(k) vs E2 "
                             f"{e2_gap:.3e}, launches {bpsf_counts}")
    ueg_gold_counts = {k: sum(c[k] for c in gold_tier.values())
                       + bpsf_counts[k] for k in counts()}
    say("22 UEG golden", f"BP two_rdm=structure_factor (tau_bp 0.05, "
        f"[2, 2, {nq33}] a split), 16 walkers, 2 blocks with injected draws: "
        f"card (complex64, pallas, launches {bpsf_counts}) vs host "
        f"(complex128, xla), max |d| over the scale: BP sums {bp_gap:.3e}, "
        f"block ETotal and weight {et_gap:.3e}, each <= 1e-4; S(k) . v_q / "
        f"2V vs the BP E2 on the "
        f"card {e2_gap:.3e} <= 1e-3" + lap("22"))
    del probe, card_af

    # ---- 23. PW_FFT ------------------------------------------------------
    # The same (7, 7), rs=1, ecut=8 electron gas on its FFT mesh (M=257,
    # 2109 q vectors with q = 0), free-electron trial, complex64, 512
    # walkers, one block of 10 steps; then 16 walkers card vs host.
    def pw_run(device, dtype, nwalkers, nblocks, energy_every):
        h = make_pw_fft(7, 7, rs=1.0, ecut=8.0, device=device, dtype=dtype)
        t = free_electron_trial(h, device=device, dtype=dtype)
        return AFQMC(h, t, QMCOpts(nwalkers=nwalkers, dt=0.005, nsteps=10,
                                   nblocks=nblocks, nstblz=5,
                                   npop_control=1, rng_seed=8),
                     estimator_options={"mixed": {
                         "energy_eval_freq": energy_every}},
                     device=device)

    zero_counts()
    af = pw_run("cuda", "single", 512, 1, 10)
    rows = af.run()
    torch.cuda.synchronize()
    pw_counts = counts()
    want = only(inv_logdet_lanes=2 + 4 * 10 + 2, chol_inv_lanes=4 * 2)
    if not (np.isfinite(rows.real).all() and pw_counts == want
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"PW_FFT rows {rows}, launches {pw_counts} "
                             f"(want {want})")
    pw_line = (f"M={af.ham.nbasis} nq={af.ham.nq} cube {af.ham.qmesh}, "
               f"free-electron trial (etrial {af.trial.etrial:.6f}), "
               f"complex64 512 walkers, one block of 10 steps: ETotal "
               f"{rows[0, 5].real:.6f}, launches {pw_counts}, "
               f"{5120 / af.block_seconds[0]:.1f} walker-steps/s (the first "
               f"block, warm-up included)")
    xi = draws.normal(size=(20, 16, af.ham.nfields))
    pop = draws.uniform(size=(20, 1))
    del af
    card = injected_blocks(pw_run("cuda", "single", 16, 2, 1), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    host = injected_blocks(pw_run("cpu", "double", 16, 2, 1), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    gap_pw = float((np.abs(card - host).max(axis=0)
                    / np.abs(host).max(axis=0)).max())
    if not (np.isfinite(card).all() and gap_pw <= 1e-4):
        raise AssertionError(f"PW_FFT card vs host: {card.tolist()} vs "
                             f"{host.tolist()} ({gap_pw:.3e})")
    os.environ.pop("PAUXY_TPU_TAYLOR_UEG", None)
    say("23 PW_FFT", pw_line + f"; 16 walkers, 2 blocks with injected "
        f"draws, card (complex64) vs host (complex128): block ETotal "
        f"{np.array2string(card[:, 0], precision=6)} vs "
        f"{np.array2string(host[:, 0], precision=6)}, max |d| over the "
        f"scale {gap_pw:.3e} <= 1e-4" + lap("23"))
    # ---- 24. the mixed estimator's density matrices ----------------------
    # Phase 4's system with the mixed 1-RDM (the generic [w, M, n] block,
    # as in JAX); the limits of tests/test_mixed_rdm.py.
    rq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=2, nstblz=10,
                 npop_control=1, rng_seed=8)
    rsteps = rq.nblocks * rq.nsteps
    rdm_opts = {"mixed": {"energy_eval_freq": 1, "one_rdm": True}}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, rq, estimator_options=rdm_opts, device="cuda")
    af.reporter.output = Pushed()
    rows = af.run()
    torch.cuda.synchronize()
    rdm_counts = counts()
    want = only(inv_logdet_lanes=2 + 6 * rsteps,
                chol_inv_lanes=4 * (rsteps // rq.nstblz))
    tmat = ham.T.cpu().numpy()
    tr_gap = e1_gap = 0.0
    for b, pushed in enumerate(af.reporter.output.blocks[:rq.nblocks]):
        g1 = pushed["one_rdm"]
        tr_gap = max(tr_gap, *(abs(np.trace(g1[s]).real - 7.0)
                               for s in (0, 1)))
        e1_gap = max(e1_gap, abs(np.sum(tmat[0] * g1[0] + tmat[1] * g1[1])
                                 .real - rows[b, 6].real))
    if af.use_fast_block or rdm_counts != want or not (
            np.isfinite(rows).all() and tr_gap <= 1e-4 and e1_gap <= 1e-3):
        raise AssertionError(f"one_rdm: launches {rdm_counts} (want {want}),"
                             f" |tr - 7| {tr_gap:.3e}, |dE1| {e1_gap:.3e}")
    rdm_line = (f"one_rdm on phase 4's system, 1024 walkers, {rsteps} steps "
                f"(the generic block): max |Tr G_s - 7| {tr_gap:.2e} <= "
                f"1e-4, max |E1B(G) - E1Body| {e1_gap:.2e} <= 1e-3, launches "
                f"{rdm_counts}, {1024 * rq.nsteps / af.block_seconds[-1]:.1f}"
                f" walker-steps/s (the second block)")
    del af
    # The UEG golden's shape with the structure factor (FFT route).
    sk_opts = {"mixed": {"energy_eval_freq": 1,
                         "two_rdm": "structure_factor"}}
    zero_counts()
    af = ueg_golden("cuda", "single", "pallas", 40, 3, sk_opts)
    af.reporter.output = Pushed()
    rows = af.run()
    torch.cuda.synchronize()
    sk_counts = counts()
    vq = af.ham.vqvec.cpu().numpy()
    pe_gap = max(abs(np.sum(vq * p["two_rdm"].sum(axis=(0, 1))).real
                     / (2.0 * af.ham.vol) - rows[b, 7].real)
                 for b, p in enumerate(af.reporter.output.blocks[:3]))
    if not (np.isfinite(rows).all() and pe_gap <= 1e-4
            and sk_counts["taylor_exp"] == 3 * af.qmc.nsteps):
        raise AssertionError(f"two_rdm S(k): |dE2| {pe_gap:.3e}, launches "
                             f"{sk_counts}")
    del af
    # Card (complex64) vs host (complex128), injected draws, 16 walkers:
    # every mixed sum with the 1-RDM tail; the UEG's without the hybrid
    # energy sum (float32 log-overlap rounding over dt, as phase 22 says),
    # with the S(k) tail.
    rdm_gap = card_vs_host(None, rdm_opts, draws.normal(size=(20, 16, 16)))
    probe = ueg_golden("cpu", "double", "xla", 16, 2, sk_opts)
    xi = draws.normal(size=(20, 16, probe.ham.nfields))
    pop = draws.uniform(size=(20, 1))
    card = extras_blocks(ueg_golden("cuda", "single", "pallas", 16, 2,
                                    sk_opts), xi, pop, 2, run_block,
                         BlockNoise)
    host = extras_blocks(probe, xi, pop, 2, run_block, BlockNoise)
    keep = [i for i in range(len(host[0][0])) if i != mixed.EHYB]
    sk_gap = float(max(np.abs(c[0][keep] - h[0][keep]).max()
                       / np.abs(h[0][keep]).max()
                       for c, h in zip(card, host)))
    os.environ.pop("PAUXY_TPU_TAYLOR_UEG", None)
    if not sk_gap <= 1e-4:
        raise AssertionError(f"UEG S(k) card vs host {sk_gap:.3e}")
    rdm_counts = {k: rdm_counts[k] + sk_counts[k] for k in counts()}
    say("24 mixed RDMs", rdm_line + f"; two_rdm=structure_factor on the UEG "
        f"golden's shape (M=33, 40 walkers, 3 blocks, pallas): S(k) . v_q "
        f"/ 2V vs E2Body max |d| {pe_gap:.2e} <= 1e-4, launches "
        f"{sk_counts}; 16 walkers, 2 blocks with injected draws, card "
        f"(complex64) vs host (complex128), max |d| over the scale: Hubbard "
        f"mixed sums with the 1-RDM {rdm_gap[0][0]:.2e}, UEG mixed sums "
        f"(hybrid sum aside) with S(k) {sk_gap:.2e}, each <= 1e-4" + lap("24"))
    del probe, card, host

    # ---- 25. NOMSD at full width -----------------------------------------
    # Phase 8's Generic bench shape with a D = 8 non-orthogonal expansion;
    # depth cut to 2 timed blocks of 10 steps after a warm-up block.
    mq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=3, nstblz=5,
                 npop_control=1, rng_seed=8)
    msteps = mq.nblocks * mq.nsteps
    zero_counts()
    ham = generic_model(128, 512, 16, make_generic)
    mpsi, mcoef = rotated_msd_psi(128, 16, 16, 8, seed=25)
    trial = multi_slater_trial(ham, mpsi, mcoef, device="cuda",
                               dtype="single")
    af = AFQMC(ham, trial, mq, propagator_options=pallas,
               estimator_options=eopts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    msd_counts = counts()
    want = only(**msd_schedule(msteps, mq.nstblz, 1, True))
    if msd_counts != want or not (
            np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"NOMSD bench: launches {msd_counts} (want "
                             f"{want}), rows {rows}")
    timed = af.block_seconds[1:]
    rate_m = mq.nwalkers * mq.nsteps * len(timed) / sum(timed)
    msd_line = (f"nmo=128 naux=512 (16,16), D=8 NOMSD (RHF identity and 7 "
                f"rotations exp(0.1 K), etrial {trial.etrial:.5f}), "
                f"complex64 taylor_impl=pallas 1024 walkers, {msteps} steps "
                f"(depth cut: a warm-up block and 2 of 10 steps): ETotal "
                f"{np.array2string(rows[:, 5].real, precision=5)}; launches "
                f"{msd_counts} as msd_schedule says; {rate_m:.1f} "
                f"walker-steps/s (phase 8, one determinant: {rate_g:.1f}; "
                f"block seconds "
                f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")
    del ham, trial, af

    def msd_bench(device, dtype, nwalkers):
        h = generic_model(128, 512, 16, make_generic, device, dtype)
        t = multi_slater_trial(h, mpsi, mcoef, device=device, dtype=dtype)
        return AFQMC(h, t, QMCOpts(nwalkers=nwalkers, dt=0.005, nsteps=10,
                                   nblocks=2, nstblz=5, npop_control=1),
                     propagator_options=pallas, estimator_options=eopts,
                     device=device)

    xi = draws.normal(size=(20, 16, 512))
    pop = draws.uniform(size=(20, 1))
    card = injected_blocks(msd_bench("cuda", "single", 16), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    host = injected_blocks(msd_bench("cpu", "double", 16), xi, pop, 2,
                           run_block, BlockNoise, mixed)
    msd_gap = float((np.abs(card - host).max(axis=0)
                     / np.abs(host).max(axis=0)).max())
    if not (np.isfinite(card).all() and msd_gap <= 2e-4):
        raise AssertionError(f"NOMSD card vs host {card.tolist()} vs "
                             f"{host.tolist()}: {msd_gap:.3e} > 2e-4")
    # MSD on phase 4's Hubbard: the UHF determinant of the continuous
    # golden and its spin flip, 1/sqrt(2) each; one block.
    uhf_c = np.asarray(np.load(os.path.join(
        ROOT, "tests", "data", "hubbard4x4_uhf_continuous.npz"))["psi"])
    flip = np.concatenate([uhf_c[:, 7:], uhf_c[:, :7]], axis=1)
    hq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=1, nstblz=10,
                 npop_control=1, rng_seed=8)
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    zero_counts()
    af = AFQMC(ham, multi_slater_trial(ham, np.stack([uhf_c, flip]),
                                       np.full(2, 2 ** -0.5),
                                       device="cuda", dtype="single"),
               hq, estimator_options=eopts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    hub_msd = counts()
    want = only(**msd_schedule(10, 10, 1, False))
    if af.use_fast_block or hub_msd != want or not np.isfinite(rows).all():
        raise AssertionError(f"Hubbard MSD: launches {hub_msd} (want "
                             f"{want}), rows {rows}")
    del af
    # D = 1 of phase 4's trial against the single-determinant block, the
    # same draws, both complex64 on the card (another order of rounding).
    fe = free_electron_trial(ham, device="cuda", dtype="single")
    one = multi_slater_trial(
        ham, torch.cat([fe.psia, fe.psib], 1).cpu().numpy()[None],
        init=torch.cat([fe.psia, fe.psib], 1).cpu().numpy(), device="cuda",
        dtype="single")
    xi = draws.normal(size=(20, 1024, 16))
    pop = draws.uniform(size=(20, 1))
    d1 = [injected_blocks(AFQMC(ham, t, QMCOpts(
        nwalkers=1024, dt=0.01, nsteps=10, nblocks=2, nstblz=10,
        npop_control=1), estimator_options=eopts, device="cuda"), xi, pop,
        2, run_block, BlockNoise, mixed) for t in (one, fe)]
    d1_gap = float((np.abs(d1[0] - d1[1]).max(axis=0)
                    / np.abs(d1[1]).max(axis=0)).max())
    if not d1_gap <= 1e-4:
        raise AssertionError(f"D=1 MSD vs single determinant {d1}")
    msd_counts = {k: msd_counts[k] + hub_msd[k] for k in counts()}
    say("25 NOMSD", msd_line + f"; 16 walkers, 2 blocks with injected draws,"
        f" card (complex64) vs host (complex128), block ETotal "
        f"{np.array2string(card[:, 0], precision=6)} vs "
        f"{np.array2string(host[:, 0], precision=6)}: max |d| over the "
        f"scale {msd_gap:.3e} <= 2e-4; Hubbard 4x4 (7,7) D=2 (the "
        f"continuous golden's UHF determinant and its spin flip) 1024 "
        f"walkers one block: ETotal {rows[0, 5].real:.5f}, launches "
        f"{hub_msd}; D=1 vs the single-determinant block, same draws, "
        f"complex64: max |d| over the scale {d1_gap:.2e} <= 1e-4" + lap("25"))
    del ham, fe, one

    # ---- 26. PHMSD zero-variance anchor ----------------------------------
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2))
    occ = list(itertools.combinations(range(6), 2))
    occa = [o for o in occ for _ in occ]
    occb = [o for _ in occ for o in occ]
    zhost = make_generic((2, 2), h1e, chol, enuc, device="cpu",
                         dtype="double")
    e_fci = float(ci.simple_fci(zhost)[0][0])
    coeffs, e0 = recompute_ci_coeffs(zhost, occa=occa, occb=occb)
    zv = {}
    for dtype, tol in (("double", 1e-8), ("single", 1e-4)):
        zham = make_generic((2, 2), h1e, chol, enuc, device="cuda",
                            dtype=dtype)
        ztrial = phmsd_trial(zham, coeffs, occa, occb, device="cuda",
                             dtype=dtype)
        zero_counts()
        af = AFQMC(zham, ztrial, QMCOpts(nwalkers=256, dt=0.01, nsteps=10,
                                         nblocks=1, nstblz=5,
                                         npop_control=1, rng_seed=8),
                   propagator_options=pallas, estimator_options=eopts,
                   device="cuda")
        # The path's launches are read around the set-up and each block
        # only: the per-walker check after a block launches kernel B too.
        walker_gap = row_gap = 0.0
        z_counts = dict.fromkeys(counts(), 0)
        for _ in range(3):
            row = af.run_block()
            torch.cuda.synchronize()
            z_counts = {k: z_counts[k] + v for k, v in counts().items()}
            ew = mixed.energy_estimator(zham, ztrial)(
                *trial_greens(ztrial, af.state.phia, af.state.phib)[:2])[0]
            walker_gap = max(walker_gap, float(
                ((ew - e_fci).abs() / abs(e_fci)).max()))
            row_gap = max(row_gap, abs(row[5].real - e_fci) / abs(e_fci))
            zero_counts()
        want = only(**msd_schedule(30, 5, 1, True))
        # Walkers exactly on determinant 0: S_d is exactly singular for the
        # 224 others (zero rows and, past single excitations, zero pivots
        # before the last). G and the overlap must be finite, the overlap
        # conj(c_0). The energy there is a reading, not E_FCI: the
        # orthogonal determinants' <D_d|H|phi> are 0 x inf limits that the
        # per-determinant formula drops (JAX's overlap is nan there).
        pa = ztrial.psia[0].expand(8, -1, -1).contiguous()
        pb = ztrial.psib[0].expand(8, -1, -1).contiguous()
        md = greens_function_multi_det(ztrial, pa, pb)
        lo = log_overlap_multi_det(ztrial, pa, pb)
        e_on = local_energy.local_energy_generic_opt_multi(
            ztrial, md.Ghalfa, md.Ghalfb, md.det_weights, zham.ecore)[0]
        on_gap = float((torch.exp(lo) - ztrial.coeffs[0].conj()).abs().max()
                       / abs(coeffs[0]))
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (md.G, md.det_weights, md.log_ovlp, lo, e_on))
        if not (finite and walker_gap <= tol and row_gap <= tol
                and on_gap <= tol and z_counts == want
                and abs(e0 - e_fci) <= 1e-10):
            raise AssertionError(
                f"PHMSD zero variance {dtype}: walkers {walker_gap:.3e}, "
                f"blocks {row_gap:.3e}, overlap on a determinant "
                f"{on_gap:.3e}, finite {finite}, limit {tol}; launches "
                f"{z_counts} (want {want})")
        zv[dtype] = (walker_gap, row_gap, on_gap,
                     float(e_on[0].real), z_counts)
        del af, zham, ztrial, md
    say("26 PHMSD zero variance", f"generate_hamiltonian(6, (2, 2)), the "
        f"full space of {len(occa)} determinants with recompute_ci_coeffs "
        f"(E0 = E_FCI {e_fci:.10f}, ci.simple_fci, float64 host), 256 "
        f"walkers, 3 blocks of 10 steps, taylor_impl=pallas: max relative "
        f"|E - E_FCI| (every walker at each block's end, every block's "
        f"ETotal) and, for walkers exactly on determinant 0 (224 S_d "
        f"exactly singular; G, weights, overlap and energy finite), "
        f"|<psi_T|phi> - conj(c_0)| / |c_0|: " + "; ".join(
            f"{k} {w:.2e}, {r:.2e}, {o:.2e} (limit "
            f"{1e-8 if k == 'double' else 1e-4:g}), the energy on the "
            f"determinant {e:.8f} (a reading), launches {c} as "
            f"msd_schedule says"
            for k, (w, r, o, e, c) in zv.items()) + lap("26"))

    # ---- 27. GHF at full width -------------------------------------------
    gd = np.load(os.path.join(ROOT, "tests", "data",
                              "hubbard4x4_uhf_discrete.npz"))
    uhf_d = np.asarray(gd["psi"])
    ua, ub = uhf_d[:, :7], uhf_d[:, 7:]
    gq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=2, nstblz=10,
                 npop_control=1, rng_seed=8)
    gsteps2 = gq.nblocks * gq.nsteps
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    zero_counts()
    gtrial = make_ghf_trial(ham, spin_flip_psi(ua, ub),
                            np.full(2, 2 ** -0.5), init=(ua, ub),
                            device="cuda", dtype="single")
    af = AFQMC(ham, gtrial, gq, propagator_options=discrete,
               estimator_options=eopts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    ghf_counts = counts()
    want = only(**ghf_schedule(gsteps2, gq.nstblz, 1))
    if ghf_counts != want or not (np.isfinite(rows).all() and bool(
            torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"GHF: launches {ghf_counts} (want {want}), "
                             f"rows {rows}")
    rate_ghf = gq.nwalkers * gq.nsteps / af.block_seconds[-1]
    del af
    # D = 1: the UHF embedding against the UHF run (its sweep kernel),
    # the walkers starting from the UHF determinant in both, the same
    # uniforms, complex64 on the card.
    uhf_t = trial_from_orbitals(ham, uhf_d, device="cuda", dtype="single")
    emb = make_ghf_trial(ham, spin_flip_psi(ua, ub)[:1], np.ones(1),
                         init=(ua, ub), device="cuda", dtype="single")
    if abs(emb.etrial - uhf_t.etrial) > 1e-4 * abs(uhf_t.etrial):
        raise AssertionError(f"GHF embedding etrial {emb.etrial} vs UHF "
                             f"{uhf_t.etrial}")
    xi = draws.uniform(size=(20, 16, 1024))
    pop = draws.uniform(size=(20, 1))
    d1 = [injected_blocks(AFQMC(ham, t, QMCOpts(
        nwalkers=1024, dt=0.01, nsteps=10, nblocks=2, nstblz=10,
        npop_control=1), propagator_options=discrete,
        estimator_options=eopts, device="cuda"), xi, pop, 2, run_block,
        BlockNoise, mixed) for t in (emb, uhf_t)]
    ghf_d1 = float(np.abs(d1[0][:, 0] / d1[1][:, 0] - 1).max())
    if not ghf_d1 <= 5e-4:
        raise AssertionError(f"D=1 GHF vs UHF block ETotal {d1}")
    # The discrete golden through the GHF embedding of its UHF trial.
    zero_counts()
    grows = AFQMC(ham, make_ghf_trial(ham, spin_flip_psi(ua, ub)[:1],
                                      np.ones(1), init=(ua, ub),
                                      device="cuda", dtype="single"),
                  QMCOpts(nwalkers=int(gd["nwalkers"]), dt=float(gd["dt"]),
                          nsteps=int(gd["nsteps"]), nblocks=100, nstblz=10,
                          npop_control=1, rng_seed=8),
                  propagator_options=discrete, estimator_options=eopts,
                  device="cuda").run()
    gold_ghf = counts()
    et = grows[:, 5].real
    ref = np.asarray(gd["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    gse = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                         theirs.std(ddof=1) / np.sqrt(len(theirs))))
    gdiff = float(abs(mine.mean() - theirs.mean()))
    if not (np.isfinite(et).all() and gdiff < max(4 * gse, 0.05)):
        raise AssertionError(f"GHF discrete golden: port {mine.mean()} "
                             f"reference {theirs.mean()} se {gse}")
    # Card vs host, D = 2, 16 walkers, injected uniforms.

    def ghf_small(device, dtype):
        h = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device=device, dtype=dtype)
        t = make_ghf_trial(h, spin_flip_psi(ua, ub), np.full(2, 2 ** -0.5),
                           init=(ua, ub), device=device, dtype=dtype)
        return AFQMC(h, t, QMCOpts(**sq), propagator_options=discrete,
                     estimator_options=eopts, device=device)

    xi = draws.uniform(size=(20, 16, 16))
    card = extras_blocks(ghf_small("cuda", "single"), xi, pop16, 2,
                         run_block, BlockNoise)
    host = extras_blocks(ghf_small("cpu", "double"), xi, pop16, 2,
                         run_block, BlockNoise)
    ghf_gap = extras_gap(card, host)[0]
    if not ghf_gap <= 1e-4:
        raise AssertionError(f"GHF card vs host {ghf_gap:.3e}")
    ghf_counts = {k: ghf_counts[k] + gold_ghf[k] for k in counts()}
    say("27 GHF", f"4x4 (7,7) U=4 discrete, D=2 GHF (the discrete golden's "
        f"UHF determinant embedded and its spin flip, etrial "
        f"{gtrial.etrial:.5f}), complex64 1024 walkers {gsteps2} steps "
        f"(scan sweep): ETotal {np.array2string(rows[:, 5].real, precision=5)}"
        f", launches as ghf_schedule says, {rate_ghf:.1f} walker-steps/s "
        f"(the second block; phase 6, one UHF determinant: {rate_d:.1f}); "
        f"D=1 embedding vs the UHF run (sweep kernel), same uniforms: max "
        f"|ETotal ratio - 1| {ghf_d1:.2e} <= 5e-4; the discrete golden "
        f"through the D=1 GHF trial (40 walkers, 100 blocks): port "
        f"{mine.mean():.6f} vs reference {theirs.mean():.6f}, |diff| "
        f"{gdiff:.6f} < max(4 se, 0.05) with se {gse:.6f}; 16 walkers, 2 "
        f"blocks with injected uniforms, card (complex64) vs host "
        f"(complex128), max |d| over the scale {ghf_gap:.2e} <= 1e-4"
        + lap("27"))
    del ham, gtrial, uhf_t, emb

    # ---- 28. Hubbard-Holstein at full width ------------------------------
    # The north-star lattice: 4x4 periodic, (7, 7), U=4, w0=1, lambda=0.25
    # (g = 1 in 2-D), dt=0.005, 1024 walkers, re-orthogonalisation and
    # population control every 5 steps, the energy every 2 steps; a
    # warm-up block and a timed one of 10 steps (depth cut).
    hq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
                 npop_control=5, rng_seed=8)
    hsteps = hq.nblocks * hq.nsteps
    eo2 = {"mixed": {"energy_eval_freq": 2}}

    def hh_model(device, dtype, **kw):
        return make_hubbard_holstein(7, 7, U=4.0, nx=4, ny=4, w0=1.0,
                                     lmbda=0.25, device=device, dtype=dtype,
                                     **kw)

    hham = hh_model("cuda", "single")
    hh_runs = {}
    for tag, trial in (("coherent", coherent_state_trial(
            hham, device="cuda", dtype="single")),
                       ("multi_coherent", multi_coherent_trial(
                           hham, device="cuda", dtype="single"))):
        zero_counts()
        af = AFQMC(hham, trial, hq, estimator_options=eo2, device="cuda")
        rows = af.run()
        torch.cuda.synchronize()
        c = counts()
        mc = tag == "multi_coherent"
        want = only(**hh_schedule(hsteps, hq.nstblz, 2, mc))
        kernel_route = af.prop.hirsch.sweep_kernel == "kernel"
        if c != want or kernel_route == mc or not (
                np.isfinite(rows).all()
                and bool(torch.isfinite(af.state.weight).all())):
            raise AssertionError(f"HH {tag}: launches {c} (want {want}), "
                                 f"sweep route {af.prop.hirsch.sweep_kernel}"
                                 f", rows {rows}")
        hh_runs[tag] = (rows[:, 5].real, c,
                        hq.nwalkers * hq.nsteps / af.block_seconds[-1],
                        af.block_seconds, getattr(trial, "nperms", 1),
                        trial.etrial)
        del af, trial
    # A short Lang-Firsov run at full width (U_eff in the Hirsch tables).
    lf_trial, _ = lang_firsov_trial(hham, device="cuda", dtype="single")
    zero_counts()
    lq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=1, nstblz=5,
                 npop_control=5, rng_seed=8)
    af = AFQMC(hham, lf_trial, lq, propagator_options={"lang_firsov": True},
               estimator_options=eo2, device="cuda")
    lf_rows = af.run()
    torch.cuda.synchronize()
    lf_counts = counts()
    want = only(**hh_schedule(lq.nsteps, 5, 2, False))
    if lf_counts != want or not (np.isfinite(lf_rows).all()
                                 and lf_rows[0, 2].real > 0):
        raise AssertionError(f"HH Lang-Firsov: launches {lf_counts} (want "
                             f"{want}), rows {lf_rows}")
    lf_rate = lq.nwalkers * lq.nsteps / af.block_seconds[-1]
    del af
    # Card (complex64) against host (complex128): 16 walkers, 2 blocks of
    # 10 steps, the same phonon start X0 and the same draws.
    draws = np.random.default_rng(28)
    hsq = dict(nwalkers=16, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
               npop_control=1, rng_seed=8)
    hh_gaps = {}
    for tag in ("coherent", "multi_coherent", "symmetric"):
        xi = hh_draws(draws, 20, 16, 16, tag == "symmetric", DMCDraws)
        pop = draws.uniform(size=(20, 1))
        x0 = draws.normal(size=(16, 16))
        out = []
        for device, dtype in (("cuda", "single"), ("cpu", "double")):
            h = hh_model(device, dtype)
            t = (multi_coherent_trial if tag == "multi_coherent"
                 else coherent_state_trial)(h, device=device, dtype=dtype)
            af = AFQMC(h, t, QMCOpts(**hsq), propagator_options={
                "symmetric_trotter": tag == "symmetric"},
                estimator_options=eopts, device=device)
            rdt = af.state.weight.dtype
            af.state = init_walkers(
                t, 16, total_weight=16.0,
                X0=t.shift.to(rdt) + torch.from_numpy(x0).to(device, rdt)
                / (2.0 * h.m * h.w0) ** 0.5)
            out.append(extras_blocks(af, xi, pop, 2, run_block, BlockNoise))
        hh_gaps[tag] = extras_gap(*out)[0]
    if not max(hh_gaps.values()) <= 1e-4:
        raise AssertionError(f"HH card vs host {hh_gaps}")
    hh_counts = {k: hh_runs["coherent"][1][k] + lf_counts[k]
                 for k in counts()}
    hh_mc_counts = hh_runs["multi_coherent"][1]
    say("28 Hubbard-Holstein", "4x4 periodic (7,7) U=4 w0=1 lambda=0.25 "
        f"(g={hham.g:.4f}), complex64 {hq.nwalkers} walkers {hsteps} steps, "
        "dt=0.005, energy every 2 steps: " + "; ".join(
            f"{tag} (P={p}, etrial {et:.5f}) ETotal "
            f"{np.array2string(e, precision=5)}, launches {c} as "
            f"hh_schedule says, {r:.1f} walker-steps/s (the second block; "
            f"block seconds {', '.join(f'{b:.4f}' for b in bs)})"
            for tag, (e, c, r, bs, p, et) in hh_runs.items())
        + f"; Lang-Firsov (etrial {lf_trial.etrial:.5f}, U_eff tables) one "
        f"block: ETotal {lf_rows[0, 5].real:.5f}, launches {lf_counts}, "
        f"{lf_rate:.1f} walker-steps/s (with the warm-up); every sweep "
        f"launch through csrc/sweep.cu on the coherent paths; 16 walkers, "
        f"2 blocks with injected draws and X0, card (complex64) vs host "
        f"(complex128), max |d| over the scale " + ", ".join(
            f"{k} {v:.2e}" for k, v in hh_gaps.items()) + " <= 1e-4"
        + lap("28"))
    del hham, lf_trial

    # ---- 29. Hubbard-Holstein anchors on the card ------------------------
    zero_counts()
    anchors = {}
    pol = make_hubbard_holstein(1, 1, U=4.0, nx=1, g=0.5, w0=1.0,
                                xpbc=False, device="cuda", dtype="single")
    exact = 4.0 - 4 * 0.5 ** 2 / 1.0
    for sym in (False, True):
        rows = AFQMC(pol, coherent_state_trial(pol, device="cuda",
                                               dtype="single"),
                     QMCOpts(nwalkers=200, dt=0.01, nsteps=20, nblocks=8,
                             nstblz=10, npop_control=10, rng_seed=7),
                     propagator_options={"symmetric_trotter": sym},
                     estimator_options=eo2, device="cuda").run()
        e = float(rows[3:, 5].real.mean())
        anchors[f"polaron{' symmetric' if sym else ''}"] = (e, exact, 0.05)
    ring = make_hubbard_holstein(1, 1, U=4.0, nx=3, w0=0.8, lmbda=0.5,
                                 device="cuda", dtype="single")
    e_bf = float(ci.simple_fci_bose_fermi(make_hubbard_holstein(
        1, 1, U=4.0, nx=3, w0=0.8, lmbda=0.5, device="cpu",
        dtype="double"), nboson_max=12)[0][0])
    rows = AFQMC(ring, multi_coherent_trial(ring, device="cuda",
                                            dtype="single"),
                 QMCOpts(nwalkers=100, dt=0.005, nsteps=20, nblocks=15,
                         nstblz=5, npop_control=5, rng_seed=7),
                 estimator_options=eo2, device="cuda").run()
    anchors["3-site multi-coherent (P=3)"] = (float(rows[5:, 5].real.mean()),
                                             e_bf, 0.2)
    chain = make_hubbard_holstein(2, 2, U=4.0, nx=4, g=0.0, w0=1.0,
                                  xpbc=False, device="cuda", dtype="single")
    e_hub = float(ci.simple_fci(make_hubbard(2, 2, U=4.0, nx=4, xpbc=False,
                                             device="cpu",
                                             dtype="double"))[0][0])
    rows = AFQMC(chain, coherent_state_trial(chain, device="cuda",
                                             dtype="single"),
                 QMCOpts(nwalkers=100, dt=0.01, nsteps=20, nblocks=12,
                         nstblz=5, npop_control=5, rng_seed=5),
                 estimator_options=eo2, device="cuda").run()
    anchors["g=0 vs Hubbard FCI"] = (float(rows[6:, 5].real.mean()), e_hub,
                                     0.3)
    lf_ham = make_hubbard_holstein(2, 2, U=4.0, nx=4, w0=1.0, lmbda=0.25,
                                   device="cuda", dtype="single")
    lf_rows = AFQMC(lf_ham, lang_firsov_trial(lf_ham, device="cuda",
                                              dtype="single")[0],
                    QMCOpts(nwalkers=16, dt=0.01, nsteps=5, nblocks=3,
                            rng_seed=2),
                    propagator_options={"lang_firsov": True},
                    estimator_options={"mixed": {"energy_eval_freq": 5}},
                    device="cuda").run()
    torch.cuda.synchronize()
    hh_anchor_counts = counts()
    missed = {k: v for k, v in anchors.items() if not abs(v[0] - v[1])
              < v[2]}
    if missed or not (np.isfinite(lf_rows).all()
                      and (lf_rows[:, 2].real > 0).all()) \
            or hh_anchor_counts["hirsch_sweep"] == 0:
        raise AssertionError(f"HH anchors missed {missed}; Lang-Firsov rows "
                             f"{lf_rows}; launches {hh_anchor_counts}")
    say("29 HH anchors", "complex64 on the card: " + "; ".join(
        f"{k} {v[0]:.5f} vs {v[1]:.5f} (|d| {abs(v[0] - v[1]):.4f} < "
        f"{v[2]})" for k, v in anchors.items())
        + " (the polaron: 1 site, (1,1), U=4, g=0.5, 200 walkers, 160 "
        "steps, E = U - 4 g^2/w0; the ring: 3 sites, U=4, w0=0.8, "
        "lambda=0.5, 100 walkers, 300 steps of 0.005 against "
        "ci.simple_fci_bose_fermi with 12 bosons; the chain: 4 sites open, "
        "(2,2), 100 walkers, 240 steps); Lang-Firsov 4-site ring, 16 "
        f"walkers, 3 blocks: weights "
        f"{np.array2string(lf_rows[:, 2].real, precision=3)} > 0; launches "
        f"{hh_anchor_counts}" + lap("29"))
    del pol, ring, chain, lf_ham

    # ---- 30. the Generic energy variants at the bench shape --------------
    vq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
                 npop_control=1, rng_seed=8)
    vsteps = vq.nblocks * vq.nsteps
    variants = {
        "exact_eri": ({"exact_eri": True}, pallas),
        "pno": ({"pno": True, "thresh_pno": 1e-13}, pallas),
        "stochastic_ri": ({"stochastic_ri": True, "nsamples": 20}, pallas),
        "stochastic_ri_cv": ({"stochastic_ri": True, "nsamples": 20,
                              "control_variate": True}, pallas),
        # The sketched one-body step needs S well above M to stay near the
        # exact step: S = 2048 = 16 M here.
        "ri_step": ({}, {"taylor_impl": "pallas", "stochastic_ri": True,
                         "nsamples": 2048}),
        "xla_3m": ({}, {"taylor_impl": "xla_3m"}),
    }

    def variant_model(flags, device="cuda", dtype="single"):
        return generic_model(128, 512, 16, lambda *a, **kw: make_generic(
            *a, **flags, **kw), device=device, dtype=dtype)

    var_runs, var_counts = {}, dict.fromkeys(counts(), 0)
    for name, (flags, popts) in variants.items():
        vham = variant_model(flags)
        vtrial = rhf_identity_trial(vham, device="cuda", dtype="single")
        zero_counts()
        af = AFQMC(vham, vtrial, vq, propagator_options=popts,
                   estimator_options=eopts, device="cuda")
        rows = af.run()
        torch.cuda.synchronize()
        c = counts()
        taylor = popts.get("taylor_impl") == "pallas"
        want = only(taylor_exp=vsteps if taylor else 0,
                    inv_logdet_lanes=2 + 6 * vsteps,
                    chol_inv_lanes=4 * (vsteps // vq.nstblz))
        if c != want or not np.isfinite(rows).all():
            raise AssertionError(f"Generic {name}: launches {c} (want "
                                 f"{want}), rows {rows}")
        var_counts = {k: var_counts[k] + c[k] for k in c}
        var_runs[name] = (rows[:, 5].real, vq.nwalkers * vq.nsteps
                          / af.block_seconds[-1])
        if name == "xla_3m":
            pop_state = af.state
        del af, vham, vtrial
    # The energies on one population (the walkers after the xla_3m run,
    # the fast path with the plain series): exact ERIs and PNO (1e-13)
    # against the fast path per walker; stochastic RI's mean over 64 probe
    # sets against the exact mean.
    fast_ham = variant_model({})
    fast_trial = rhf_identity_trial(fast_ham, device="cuda", dtype="single")
    ga = greens.greens_function(pop_state.phia, fast_trial.psia, False)
    gb = greens.greens_function(pop_state.phib, fast_trial.psib, False)
    e_fast = local_energy.local_energy_generic_opt(
        fast_trial, ga.Ghalf, gb.Ghalf, 0.0)[0].real
    var_gap = {}
    for name in ("exact_eri", "pno"):
        vt = rhf_identity_trial(variant_model(variants[name][0]),
                                device="cuda", dtype="single")
        e = getattr(local_energy, "local_energy_generic_" + name)(
            vt, ga.Ghalf, gb.Ghalf, 0.0)[0].real
        var_gap[name] = float(((e - e_fast).abs() / e_fast.abs()).max())
        del vt
    sri = {}
    gen_sri = torch.Generator(device="cuda")
    gen_sri.manual_seed(30)
    for cv in (False, True):
        vt = rhf_identity_trial(variant_model(
            {"stochastic_ri": True, "nsamples": 20, "control_variate": cv}),
            device="cuda", dtype="single")
        means = torch.stack([local_energy.local_energy_generic_stochastic_ri(
            vt, ga.Ghalf, gb.Ghalf, 0.0, local_energy.rademacher(
                (512, 20), torch.float32, gen_sri, "cuda"), cv)[0].real.mean()
            for _ in range(64)]).double()
        se = float(means.std() / 8.0)
        d = abs(float(means.mean()) - float(e_fast.double().mean()))
        sri["control variate" if cv else "plain"] = (d, se)
        del vt
    sri_bad = {k: v for k, v in sri.items() if not v[0] <= 4 * v[1]}
    if max(var_gap.values()) > 1e-4 or sri_bad:
        raise AssertionError(f"Generic variants: relative gaps {var_gap}, "
                             f"stochastic RI {sri}")
    del pop_state, fast_trial, ga, gb, e_fast
    # Card (complex64) against host (complex128) on the golden system, 16
    # walkers, 2 blocks with injected draws (the fields, the sketches and
    # the energy's probes).
    vdraws = np.random.default_rng(30)
    n11 = g_gen["h1e"].shape[-1]
    naux11 = np.asarray(g_gen["chol"]).shape[0]
    var_gaps = {}
    for name, (flags, popts) in variants.items():
        step = popts.get("stochastic_ri", False)
        fields = vdraws.normal(size=(20, 16, naux11))
        xi = ([RIDraws(fields[i], *(vdraws.choice([-1.0, 1.0],
                                                  size=(n11, 20))
                                    for _ in range(2)))
               for i in range(20)] if step else list(fields))
        est = (vdraws.choice([-1.0, 1.0], size=(20, naux11, 20))
               if flags.get("stochastic_ri") else None)
        pop = vdraws.uniform(size=(20, 1))
        out = []
        for device, dtype in (("cuda", "single"), ("cpu", "double")):
            h = make_generic((3, 3), np.stack([g_gen["h1e"], g_gen["h1e"]]),
                             np.asarray(g_gen["chol"]).reshape(-1, n11, n11)
                             .transpose(1, 2, 0), ecore=float(g_gen["enuc"]),
                             device=device, dtype=dtype, **flags)
            t = trial_from_orbitals(h, np.asarray(g_gen["psi"]),
                                    device=device, dtype=dtype)
            af = AFQMC(h, t, QMCOpts(**sq), propagator_options=popts,
                       estimator_options=eopts, device=device)
            out.append(extras_blocks(af, xi, pop, 2, run_block, BlockNoise,
                                   est))
        var_gaps[name] = extras_gap(*out)[0]
    if not max(var_gaps.values()) <= 1e-4:
        raise AssertionError(f"Generic variants card vs host {var_gaps}")
    say("30 Generic variants", f"nmo=128 naux=512 (16,16) RHF complex64 "
        f"{vq.nwalkers} walkers {vsteps} steps (a warm-up block and a timed "
        f"one): " + "; ".join(
            f"{k} ETotal {np.array2string(e, precision=5)}, {r:.1f} "
            f"walker-steps/s" for k, (e, r) in var_runs.items())
        + f" (phase 8's fast path {rate_g:.1f}); launches as phase 8's "
        f"schedule says (no Taylor kernel with xla_3m); on one population "
        f"the exact_eri and pno (1e-13) energies against the fast path's, "
        f"max relative |d| " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in var_gap.items())
        + " <= 1e-4; stochastic RI (20 probes) mean over 64 probe sets vs "
        "the exact mean: " + ", ".join(f"{k} |d| {d:.2e} (se {s:.2e})"
                                       for k, (d, s) in sri.items())
        + " within 4 se; the golden system, 16 walkers, 2 blocks with "
        "injected draws, "
        f"card (complex64) vs host (complex128), max |d| over the scale "
        + ", ".join(f"{k} {v:.2e}" for k, v in var_gaps.items())
        + " <= 1e-4" + lap("30"))

    # ---- 31. the file path at full width ---------------------------------
    # Phase 8's bench shape, but from files: the port's writers put the
    # Hamiltonian and the trial into a temporary directory, a JSON input
    # names them, and setup_calculation builds the driver on the card.
    from pauxy_tpu_torch import native
    from pauxy_tpu_torch.qmc.calc import setup_calculation
    from pauxy_tpu_torch.utils import (h5lite, hamiltonian_converter,
                                       qmcpack, sgto)
    from pauxy_tpu_torch.utils import wavefunction as wfn_io

    # Phase 8's run settings and the Generic golden system (later phases
    # rebind phase 8's and phase 10's names).
    fq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=4, nstblz=5,
                 npop_control=1, rng_seed=8)
    fsteps = fq.nblocks * fq.nsteps
    gn = g_gen["h1e"].shape[-1]
    work = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        import h5py  # noqa: F401
        h5_module = "h5py"
    except ImportError:
        h5_module = "the port's h5lite"
    h1, chol = generic_arrays(128, 512)
    ham_file = os.path.join(work, "afqmc.h5")
    wfn_file = os.path.join(work, "wfn.h5")
    qmcpack.write_hamiltonian(h1, chol, (16, 16), ecore=0.0,
                              filename=ham_file)
    eye = np.eye(128)
    psi = np.concatenate([eye[:, :16], eye[:, :16]], axis=1)
    wfn_io.write_wavefunction(psi, wfn_file)

    def file_input(name, **sections):
        opts = {"system": {"name": "Generic", "integrals": ham_file},
                "qmc": {"nwalkers": fq.nwalkers, "dt": fq.dt,
                        "nsteps": fq.nsteps, "blocks": fq.nblocks,
                        "stabilise_freq": fq.nstblz, "pop_control_freq": 1,
                        "rng_seed": fq.rng_seed},
                "trial": {"name": "hartree_fock", "filename": wfn_file},
                "propagator": pallas,
                "estimates": {"mixed": {"energy_eval_freq": 1},
                              "filename": os.path.join(work, f"{name}.h5")},
                "verbosity": 0}
        opts.update(sections)
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(opts, fh)
        return path

    zero_counts()
    t0 = time.perf_counter()
    af = setup_calculation(file_input("generic_file"), device="cuda")
    setup_wall = time.perf_counter() - t0
    driver_setup = af.timing["setup"]
    exact = {
        "H1": bool(torch.equal(af.ham.H1[0].cpu(),
                               torch.from_numpy(h1.astype(np.float32)))),
        "chol": bool(torch.equal(af.ham.chol.cpu(), torch.from_numpy(
            chol.astype(np.float32)))),
        "ecore": af.ham.ecore == 0.0,
        "psi": bool(torch.equal(af.trial.psia.cpu(), torch.from_numpy(
            psi[:, :16].astype(np.complex64)))) and bool(torch.equal(
                af.trial.psib.cpu(), af.trial.psia.cpu())),
    }
    if not all(exact.values()) or af.prop.inner.taylor_impl != "pallas":
        raise AssertionError(f"file path: loaded arrays differ from the "
                             f"written ones {exact}")
    rows = af.run()
    torch.cuda.synchronize()
    file_counts = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the file path: {rows}")
    want = only(taylor_exp=fsteps, inv_logdet_lanes=2 + 6 * fsteps,
                chol_inv_lanes=4 * (fsteps // fq.nstblz))
    if file_counts != want:
        raise AssertionError(f"file path launches {file_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_f = fq.nwalkers * fq.nsteps * len(timed) / sum(timed)
    file_energy = af.get_energy()
    # Restart at the same shape: 3 blocks straight against 2 blocks, a
    # checkpoint, a new driver from it and 1 block (the walkers section).
    restart = os.path.join(work, "restart.h5")
    straight = setup_calculation(file_input("straight"), device="cuda")
    srows = [straight.run_block() for _ in range(3)]
    first = setup_calculation(file_input(
        "first", walkers={"write_freq": 2, "write_file": restart}),
        device="cuda")
    for _ in range(2):
        first.run_block()
    second = setup_calculation(file_input(
        "second", walkers={"read_file": restart}), device="cuda")
    rrow = second.run_block()
    restart_gap = float((np.abs(rrow[:10] - srows[2][:10])
                         / np.maximum(np.abs(srows[2][:10]), 1e-300)).max())
    if second.step != 3 * fq.nsteps or restart_gap > 1e-6:
        raise AssertionError(f"restart: block 3 {rrow[:10]} vs straight "
                             f"{srows[2][:10]}: {restart_gap:.3e} > 1e-6")
    del af, straight, first, second
    # Card (complex64) vs host (complex128) on the golden system written to
    # files, 2 blocks with injected draws (phase 10's limit).
    gham_file = os.path.join(work, "golden.h5")
    gwfn_file = os.path.join(work, "golden_wfn.h5")
    qmcpack.write_hamiltonian(
        g_gen["h1e"], np.asarray(g_gen["chol"]).reshape(-1, gn, gn)
        .transpose(1, 2, 0), (3, 3), ecore=float(g_gen["enuc"]),
        filename=gham_file)
    wfn_io.write_wavefunction(np.asarray(g_gen["psi"]), gwfn_file)
    gopts = {"system": {"name": "Generic", "integrals": gham_file},
             "qmc": dict(golden_qmc, blocks=2, rng_seed=8),
             "trial": {"name": "hartree_fock", "filename": gwfn_file},
             "propagator": pallas, "verbosity": 0,
             "estimates": {"mixed": {"energy_eval_freq": 1},
                           "filename": os.path.join(work, "golden_est.h5")}}
    gdraws = np.random.default_rng(31)
    xi = gdraws.normal(size=(2 * golden_qmc["nsteps"],
                             golden_qmc["nwalkers"], g_gen["chol"].shape[0]))
    pop = gdraws.uniform(size=(2 * golden_qmc["nsteps"], 1))
    card_f = injected_blocks(setup_calculation(gopts, device="cuda"), xi,
                             pop, 2, run_block, BlockNoise, mixed)
    host_f = injected_blocks(setup_calculation(gopts, device="cpu",
                                               dtype="double"), xi, pop, 2,
                             run_block, BlockNoise, mixed)
    file_gap = float((np.abs(card_f - host_f).max(axis=0)
                      / np.abs(host_f).max(axis=0)).max())
    if not file_gap <= 2e-4:
        raise AssertionError(f"golden system from files: card {card_f} vs "
                             f"host {host_f}: {file_gap:.3e} > 2e-4")
    say("31 file path", f"nmo=128 naux=512 (16,16) written by the port "
        f"({h5_module}) and read through setup_calculation: H1, chol, ecore "
        f"and the trial's orbitals equal the written arrays cast to "
        f"float32/complex64; taylor_impl=pallas {fq.nwalkers} walkers "
        f"{fsteps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=5)}, get_energy "
        f"{file_energy}; launches {file_counts} (phase 8's schedule); "
        f"{rate_f:.1f} walker-steps/s over {len(timed)} blocks after a "
        f"warm-up block (phase 8 in this run {rate_g:.1f}); set-up: "
        f"setup_calculation {setup_wall:.3f} s (the h5 reads and the trial), "
        f"the driver's timing['setup'] {driver_setup:.3f} s; restart "
        f"(2 blocks, checkpoint, 1 block) vs 3 blocks straight: max relative "
        f"|d| over the row's columns {restart_gap:.3e} <= 1e-6; the golden "
        f"system "
        f"from files, 2 blocks with injected draws, card (complex64) vs host "
        f"(complex128) {file_gap:.3e} <= 2e-4" + lap("31"))

    # ---- 32. the molecular anchors from files ----------------------------
    # H10/STO-6G at R = 1.6 a0 through sgto.dump_afqmc's files, as
    # tests/test_sgto.py's anchor (100 walkers, dt 0.005, 1000 blocks,
    # energy every 10 steps, re-orthogonalisation every 5), on the card.
    h10_dir = os.path.join(work, "h10")
    h10_input = sgto.dump_afqmc(10, 1.6, prefix=h10_dir, nwalkers=100,
                                dt=0.005, nblocks=1000)
    bas, charges, coords, enuc = sgto.hydrogen_chain(10, 1.6)
    e_uhf = sgto.uhf(bas, charges, coords, (5, 5), enuc)[0]
    if abs(e_uhf - (-5.2562816)) > 1e-5:
        raise AssertionError(f"H10 UHF energy {e_uhf} != -5.2562816")
    with open(h10_input) as fh:
        h10_opts = json.load(fh)
    h10_opts["qmc"]["stabilise_freq"] = 5
    h10_opts["propagator"] = pallas
    h10_opts["estimates"] = {"mixed": {"energy_eval_freq": 10},
                             "filename": os.path.join(h10_dir, "est.h5")}
    h10_opts["verbosity"] = 0
    zero_counts()
    af = setup_calculation(h10_opts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    h10_counts = counts()
    hsteps = af.qmc.nsteps * af.qmc.nblocks
    want = only(taylor_exp=hsteps,
                inv_logdet_lanes=2 + 4 * hsteps + 2 * (hsteps // 10),
                chol_inv_lanes=4 * (hsteps // 5))
    et = rows[20:, 5].real
    b40 = et[: len(et) // 40 * 40].reshape(-1, 40).mean(axis=1)
    se_h10 = float(b40.std(ddof=1) / np.sqrt(len(b40)))
    comb = float(np.hypot(se_h10, 0.0014386))
    e_h10 = float(et.mean())
    from pauxy_tpu_torch.analysis import blocking as port_blocking

    s = port_blocking.reblock_summary(rows[:, 5].real)
    h10_energy = af.get_energy()
    h10_rate = af.qmc.nwalkers * af.qmc.nsteps * (len(af.block_seconds)
                                                  - 1) / sum(
        af.block_seconds[1:])
    if (h10_counts != want or not np.isfinite(rows.real).all()
            or abs(e_h10 - (-5.38331344)) >= 4 * comb
            or h10_energy != (float(s["mean"]),
                              float(s["standard error"]))):
        raise AssertionError(f"H10 anchor: E {e_h10} (se {se_h10}) vs "
                             f"-5.38331344 +/- 0.0014386; get_energy "
                             f"{h10_energy} vs {s}; launches {h10_counts}, "
                             f"want {want}")
    del af
    # The H2 MO-basis golden (tests/data/h2_mo_r1.4.npz): 200 walkers,
    # dt 0.01, 300 blocks, energy every step, 10-block reblocking.
    h2_dir = os.path.join(work, "h2")
    os.makedirs(h2_dir)
    h2ham, h2psi, _ = sgto.molecule_afqmc(
        [("H", (0, 0, 0)), ("H", (1.4, 0, 0))], (1, 1), chol_tol=1e-10,
        device="cpu", dtype="double")
    qmcpack.write_hamiltonian(h2ham.H1[0].numpy(), h2ham.chol.numpy(),
                              (1, 1), ecore=h2ham.ecore,
                              filename=os.path.join(h2_dir, "afqmc.h5"))
    wfn_io.write_wavefunction(h2psi, os.path.join(h2_dir, "wfn.h5"))
    h2_opts = {"system": {"name": "Generic",
                          "integrals": os.path.join(h2_dir, "afqmc.h5")},
               "qmc": {"nwalkers": 200, "dt": 0.01, "nsteps": 10,
                       "blocks": 300, "stabilise_freq": 5,
                       "pop_control_freq": 5, "rng_seed": 8},
               "trial": {"name": "hartree_fock",
                         "filename": os.path.join(h2_dir, "wfn.h5")},
               "propagator": pallas, "verbosity": 0,
               "estimates": {"mixed": {"energy_eval_freq": 1},
                             "filename": os.path.join(h2_dir, "est.h5")}}
    zero_counts()
    rows = setup_calculation(h2_opts, device="cuda").run()
    torch.cuda.synchronize()
    h2_counts = counts()

    def blocked_se(x):
        b = x[: len(x) // 10 * 10].reshape(-1, 10).mean(axis=1)
        return b.std(ddof=1) / np.sqrt(len(b))

    et = rows[150:, 5].real
    h2_ref = np.load(os.path.join(ROOT, "tests", "data",
                                  "h2_mo_r1.4.npz"))["etotal"][150:]
    se_h2 = float(np.hypot(blocked_se(et), blocked_se(h2_ref)))
    d_h2 = abs(float(et.mean()) - float(h2_ref.mean()))
    if not (np.isfinite(rows.real).all() and d_h2 < 4 * se_h2
            and h2_counts["taylor_exp"] == 3000):
        raise AssertionError(f"H2 golden: {et.mean()} vs {h2_ref.mean()}, "
                             f"se {se_h2}; launches {h2_counts}")
    # The CLI on the card: python -m pauxy_tpu_torch on the H10 input cut
    # to 8 blocks, in a process of its own.
    cli_input = os.path.join(h10_dir, "cli.json")
    with open(cli_input, "w") as fh:
        json.dump(dict(h10_opts, qmc=dict(h10_opts["qmc"], blocks=8),
                       estimates={"mixed": {"energy_eval_freq": 10}},
                       verbosity=1), fh)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "pauxy_tpu_torch", cli_input],
        capture_output=True, text=True, cwd=h10_dir, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0 or "# Reblocked estimates:" not in cli.stdout:
        raise AssertionError(f"CLI exit {cli.returncode}:\n{cli.stdout}\n"
                             f"{cli.stderr[-3000:]}")
    table = cli.stdout.split("# Reblocked estimates:")[-1].strip()
    say("32 molecular anchors", f"H10/STO-6G R=1.6 from sgto.dump_afqmc's "
        f"files: E_UHF {e_uhf:.7f}; complex64, taylor_impl=pallas, 100 "
        f"walkers, 1000 blocks: E {e_h10:.6f} (40-block se {se_h10:.6f}) vs "
        f"-5.38331344 +/- 0.0014386, |d| {abs(e_h10 + 5.38331344):.6f} < 4 "
        f"combined sigma {4 * comb:.6f}; get_energy {h10_energy} = "
        f"reblock_summary of the rows; launches {h10_counts}; "
        f"{h10_rate:.1f} walker-steps/s; H2 MO golden from files (200 "
        f"walkers, 300 blocks): {et.mean():.6f} vs {h2_ref.mean():.6f}, |d| "
        f"{d_h2:.6f} < 4 se {4 * se_h2:.6f}; launches {h2_counts}; "
        f"python -m pauxy_tpu_torch on the H10 input (8 blocks) exit 0 in "
        f"{cli_s:.1f} s, table: {' '.join(table.split())}" + lap("32"))

    # ---- 33. FCIDUMP and k-points ----------------------------------------
    # H10's integrals (the sgto path's MO-basis Hamiltonian, float64) as an
    # FCIDUMP, real and (with imaginary one-body couplings) complex.
    h10ham = sgto.hydrogen_chain_afqmc(10, 1.6, device="cpu",
                                       dtype="double")[0]
    h1_10 = h10ham.H1[0].numpy()
    c10 = h10ham.chol.numpy()
    eri10 = np.einsum("ikx,jlx->ikjl", c10, c10)
    m10 = h1_10.shape[0]

    def write_fcidump(path, h1, cplx):
        fmt = ((lambda v: f"({v.real:.17e}, {v.imag:.17e})") if cplx
               else (lambda v: f"{v.real:.17e}"))
        lines = [f"&FCI NORB={m10},NELEC=10,MS2=0,",
                 "ORBSYM=" + "1," * m10, "&END"]
        for i in range(m10):
            for k in range(i + 1):
                for j in range(m10):
                    for l in range(j + 1):
                        if i * m10 + k >= j * m10 + l:
                            lines.append(f"{fmt(eri10[i, k, j, l])} {i + 1} "
                                         f"{k + 1} {j + 1} {l + 1}")
        for i in range(m10):
            for j in range(i + 1):
                lines.append(f"{fmt(h1[i, j])} {i + 1} {j + 1} 0 0")
        lines.append(f"{fmt(h10ham.ecore + 0j)} 0 0 0 0")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    rng33 = np.random.default_rng(33)
    herm = rng33.normal(scale=1e-3, size=(m10, m10))
    h1_c = h1_10 + 1j * (herm - herm.T)
    native_calls = []
    fill = native.fcidump_fill
    native.fcidump_fill = lambda *a: native_calls.append(a[1]) or fill(*a)
    parse = {}
    try:
        for tag, h1, cplx in (("real", h1_10, False), ("complex", h1_c,
                                                        True)):
            path = os.path.join(work, f"FCIDUMP_{tag}")
            write_fcidump(path, h1, cplx)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                t0 = time.perf_counter()
                got = qmcpack.read_fcidump(path)
                t_native = time.perf_counter() - t0
            native.fcidump_fill = lambda *a: None
            t0 = time.perf_counter()
            oracle = qmcpack.read_fcidump(path)
            t_python = time.perf_counter() - t0
            native.fcidump_fill = (lambda *a: native_calls.append(a[1])
                                   or fill(*a))
            same = (np.array_equal(got[0], oracle[0])
                    and np.array_equal(got[1], oracle[1])
                    and got[2:] == oracle[2:]
                    and np.iscomplexobj(got[1]) == cplx)
            if not same:
                raise AssertionError(f"FCIDUMP {tag}: native and Python "
                                     f"parses differ")
            parse[tag] = (t_native, t_python)
    finally:
        native.fcidump_fill = fill
    if not (native.available() and native_calls == [m10, m10]
            and native.library_path().exists()):
        raise AssertionError(f"native parser: available "
                             f"{native.available()} ({native.load_error()}),"
                             f" calls {native_calls}")
    real_dump = os.path.join(work, "FCIDUMP_real")
    kw64 = dict(device="cuda", dtype="double")
    e_sgto = rhf_identity_trial(h10ham.to("cuda"), **kw64).etrial
    e_fcidump = rhf_identity_trial(qmcpack.fcidump_to_system(
        real_dump, chol_tol=1e-12, **kw64), **kw64).etrial
    converted = os.path.join(work, "fcidump_afqmc.h5")
    conv = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bin", "fcidump-to-afqmc-torch"),
         real_dump, "-o", converted, "--chol-tol", "1e-12"],
        capture_output=True, text=True, cwd=work, timeout=300)
    if conv.returncode != 0:
        raise AssertionError(f"fcidump-to-afqmc-torch: {conv.stderr}")
    from pauxy_tpu_torch.models.generic import from_qmcpack_file

    e_script = rhf_identity_trial(from_qmcpack_file(converted, **kw64),
                                  **kw64).etrial
    rel = max(abs(e_fcidump - e_sgto), abs(e_script - e_sgto)) / abs(e_sgto)
    if not rel <= 1e-8:
        raise AssertionError(f"RHF energies: sgto {e_sgto}, FCIDUMP "
                             f"{e_fcidump}, script {e_script}")
    # A k-point file (3 k-points on a ring, 2 orbitals each) round trip.
    nkp, kmo, knc = 3, 2, 4
    nmo_pk = np.full(nkp, kmo, dtype=np.int32)
    nchol_pk = np.full(nkp, knc, dtype=np.int32)
    qk_k2 = np.array([[(k - q) % nkp for k in range(nkp)]
                      for q in range(nkp)], dtype=np.int32)
    minus_k = np.array([(-q) % nkp for q in range(nkp)], dtype=np.int32)
    hk = [h + h.conj().T for h in (rng33.normal(size=(kmo, kmo))
                                   + 1j * rng33.normal(size=(kmo, kmo))
                                   for _ in range(nkp))]
    lk = []
    for q in range(nkp):
        if minus_k[q] < q:
            lk.append([c.conj() for c in lk[minus_k[q]]])
            continue
        im = 0.0 if minus_k[q] == q else 1.0
        lk.append([rng33.normal(size=(kmo * kmo, knc))
                   + im * 1j * rng33.normal(size=(kmo * kmo, knc))
                   for _ in range(nkp)])
    kfile = os.path.join(work, "kpoint.h5")
    hamiltonian_converter.write_qmcpack_cholesky_kpoint(
        kfile, hk, lk, enuc=1.25, nelec=(3, 3), nmo_pk=nmo_pk, qk_k2=qk_k2,
        minus_k=minus_k, nchol_pk=nchol_pk)
    back = hamiltonian_converter.read_qmcpack_cholesky_kpoint(kfile)
    k_ok = (all(np.array_equal(a, b) for a, b in zip(back[0], hk))
            and all(np.array_equal(np.asarray(back[1][q]).reshape(-1),
                                   np.stack([c.reshape(-1) for c in lk[q]])
                                   .reshape(-1)) for q in range(nkp))
            and back[2] == 1.25 and back[4] == (3, 3))
    kh, kc = hamiltonian_converter.kpoint_to_supercell(
        back[0], back[1], nmo_pk, qk_k2, nchol_pk)
    kham = make_generic((3, 3), kh, kc, 1.25, device="cuda", dtype="single")
    if not (k_ok and bool(torch.isfinite(kham.h1e_mod).all())):
        raise AssertionError("k-point file round trip failed")
    shutil.rmtree(work, ignore_errors=True)
    say("33 FCIDUMP and k-points", f"H10's MO integrals (M={m10}) as an "
        f"FCIDUMP: the native parser ({os.path.relpath(native.library_path(), ROOT)}, "
        f"built with g++ at first use, {len(native_calls)} calls, no "
        f"warning) equals the Python oracle exactly, real and complex "
        f"(seconds native / Python: "
        + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in parse.items())
        + f"); RHF energy (complex128 on the card) sgto {e_sgto:.12f}, "
        f"fcidump_to_system {e_fcidump:.12f}, fcidump-to-afqmc-torch "
        f"{e_script:.12f}: max relative |d| {rel:.2e} <= 1e-8; the k-point "
        f"file (3 k-points) round-trips exactly and its supercell Generic "
        f"(M={kham.nbasis}, X={kham.nchol}) builds on the card" + lap("33"))
    # ---- 34. the walker mesh on the card ----------------------------------
    msg, mesh_cont, mesh_gen, mesh_chol = mesh_phase(counts, zero_counts)
    say("34 walker mesh", msg + lap("34"))

    # ---- 35. the matmul-precision ladder ---------------------------------
    msg, ladder_counts, gemm_row = ladder_phase(tier_cases, counts,
                                                zero_counts)
    say("35 matmul ladder", msg + lap("35"))

    # ---- 36. HDF5 without h5py -------------------------------------------
    say("36 h5lite", h5lite_phase() + lap("36"))

    # ---- 37. the plane-wave force-bias kernel ----------------------------
    msg, pw_row = pw_force_bias_phase()
    say("37 pw force bias", msg + lap("37"))
    for k, r in (("gemm_bf16x3", gemm_row), ("pw_force_bias", pw_row)):
        err[k], times[k] = r["err"], r["times"]
        bounds[k], at_shapes[k] = r["bound"], r["at_shapes"]
    say("seconds", json.dumps(seconds))

    # ---- result ----------------------------------------------------------
    print(nvidia_smi())
    meta = {
        "greens_lanes": ("pauxy_tpu_torch/csrc/greens.cu",
                         "pauxy_tpu/ops/greens_pallas.py:61"),
        "inv_logdet_lanes": ("pauxy_tpu_torch/csrc/batchla.cu",
                             "pauxy_tpu/ops/batchla_pallas.py:135"),
        "chol_inv_lanes": ("pauxy_tpu_torch/csrc/chol_inv.cu",
                           "pauxy_tpu/ops/batchla_pallas.py:255"),
        "hirsch_sweep": ("pauxy_tpu_torch/csrc/sweep.cu",
                         "pauxy_tpu/ops/sweep_pallas.py:54"),
        "taylor_exp": ("pauxy_tpu_torch/csrc/taylor.cu",
                       "pauxy_tpu/ops/taylor_pallas.py:47"),
        "taylor_bf16": ("pauxy_tpu_torch/csrc/taylor_bf16.cu",
                        "pauxy_tpu/ops/taylor_pallas.py:56"),
        "exx": ("pauxy_tpu_torch/csrc/exx.cu",
                "pauxy_tpu/ops/exx_pallas.py:36"),
        "cpqr": ("pauxy_tpu_torch/csrc/cpqr.cu",
                 "pauxy_tpu/ops/cpqr_pallas.py:89"),
        # No Pallas kernel: JAX's 'bfloat16_3x' tier reaches XLA's dot.
        "gemm_bf16x3": ("pauxy_tpu_torch/csrc/gemm_bf16x3.cu",
                        "pauxy_tpu/config.py:91"),
        # No TPU kernel: JAX's fft_coulomb_terms is plain XLA.
        "pw_force_bias": ("pauxy_tpu_torch/csrc/pw_force_bias.cu", "none"),
    }
    by_path = {"continuous": cont, "discrete": disc, "generic": gen_counts,
               "generic_exx": exx_counts, "thermal_ueg": ueg_counts,
               "thermal_hubbard": hub_counts, "bp_discrete": bp_counts,
               "tutorial_3x3": tut_counts, "free_projection": fp_counts,
               "bp_generic": bpg_counts, "thermal_ueg_lowrank": lr_counts,
               "thermal_discrete": td_counts, "thermal_generic": tg_counts,
               "thermal_mean_field": mf_counts,
               "thermal_average_gf": avg_counts, "ueg": planewave_counts,
               "ueg_golden": ueg_gold_counts, "pw_fft": pw_counts,
               "mixed_rdm": rdm_counts, "msd": msd_counts,
               "phmsd_zero_variance": {k: sum(v[-1][k] for v in zv.values())
                                       for k in counts()},
               "ghf": ghf_counts, "hh": hh_counts, "hh_mc": hh_mc_counts,
               "hh_anchors": hh_anchor_counts,
               "generic_variants": var_counts, "generic_file": file_counts,
               "h10_file": h10_counts, "h2_file": h2_counts,
               "mesh_continuous": mesh_cont, "mesh_generic": mesh_gen,
               "matmul_ladder": ladder_counts,
               **{f"mesh_chol_{k}": c for k, c in mesh_chol.items()}}
    # Every kernel of the chol-mesh paths launched there.
    for k, run in (("chol_inv_lanes", "bp"), ("taylor_exp", "bp"),
                   ("inv_logdet_lanes", "bp"), ("exx", "bp"),
                   ("cpqr", "thermal")):
        if mesh_chol[run][k] == 0:
            raise AssertionError(f"chol mesh {run}: {k} never launched")
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k] for c in by_path.values()),
         "launches_by_path": {p: c[k] for p, c in by_path.items()},
         "launches_by_route": ({r: sum(c[f"{k}_{r}"] for c in by_path.values())
                                for r in ROUTES[k]}
                               if k in ROUTES else None),
         "max_abs_err": err[k],
         "ms": times[k]["kernel"], "device_ms": times[k].get("device"),
         "two_calls_ms": times[k].get("two_calls"),
         "f32_kernel_ms": times[k].get("f32_kernel"),
         "streaming_ms": times[k].get("streaming"),
         "streaming_device_ms": times[k].get("streaming_device"),
         "plain_ms": times[k]["plain"],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": times[k].get("library"),
         "tf32_ms": times[k].get("tf32"), "at_shapes": at_shapes[k]}
        for k, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
