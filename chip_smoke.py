"""Drive the PyTorch + CUDA port's main path on one CUDA card and check it.

Run from the repo root with no arguments:  python3 chip_smoke.py

Four paths of the JAX package run here.  The banded path: SparseBuilder
assembly → CSR → DIA → spmv / spmv_dot / spmv_chain → solvers.cg, on the
2-D 5-point Poisson operator at 2048² = 4,194,304 rows (the reference
benchmark's cg_f32_4M), whose chain runs the cooperative grid kernel, and
spmv_chain at k = 1024 on a 10⁴-row 5-diagonal band (the reference
benchmark's banded_1e4 chain), which runs the cluster kernel.  The FEM path: SparseBuilder assembly → CSR →
StripELL → spmv through the row-group SpMV kernel over its compact plan →
the preconditioned solvers, on the pwtk-class surrogate
``matgen.fem_block_band()`` at its full 217,920 rows (the reference
benchmark's fem config), made SPD by a dominant diagonal.  The circuit
path: io.save_mtx → io.load_mtx → CSR → RouteStream → checkpoint.save_matrix
/ load_matrix → spmv through the merge-path route kernel over the
RouteStream's compact plan at G = 1 (its CSR) → BiCGStab, GMRES(30),
Jacobi and PCG(Jacobi), on the scircuit-class surrogate
``matgen.circuit_scatter() * 2e-2`` at its full 170,998 rows (the reference
benchmark's config 4a).  The SpMM path: the pwtk-class operator
``matgen.fem_block_band() * 2e-2`` at its full 217,920 rows (the reference
benchmark's fem SpMV/SpMM configs) → CSR → BSR.from_csr_device (512×128
blocks) → spmm at m = 128 through the row-group kernel over the BSR's
compact plan, and → SlabPack / SlabELL → spmv through the row-group SpMV
kernel and spmm through the row-group SpMM kernel over their plan (one plan
per matrix, the same for both).  The general-matrix path: the circuit
operator through io.load_mtx and checkpoint.load_matrix with no device
named (the current card) → WELL → spmv through the row-group SpMV kernel
over its plan →
BiCGStab, GMRES(30) and rmatvec; the FEM operator → SlabStream → spmv
through the row-group SpMV kernel over its plan (the plan of the StripELL
and SlabPack of the same CSR) → PCG(Jacobi); auto_format on the Poisson,
FEM and circuit operators.  Last, the matrix algebra on the FEM operator,
SpGEMM (A·A of the circuit operator and of the FEM operator at full size,
through spgemm's ESC path) and SOR / Gauss-Seidel over the level schedule.
Then the distribution layer (sparsemat_tpu_torch.parallel) at a world of
one rank under NCCL: the Poisson operator through DistDIA into CG, and the
FEM operator through DistCSR, DistELL, DistCSRSubset and DistSlab, each
rank's product on the same CUDA kernels.

Phases (one line each; any failure raises and the exit code is non-zero):
  1 device      the card, and nvidia-smi's name and power limit
  2 build       the CUDA kernels (one nvcc per source, all at once, sm_90a)
                and the C++ assembly store
  3 kernels     each DIA kernel against its plain PyTorch version, f32 and
                f64: odd n, offsets straddling 128, a one-row band, ±4096
                halos (on 2^20 and on 20,000 rows), a rectangular matrix,
                the 10⁴-row band; the chain at k = 1, 2, 5, 1024 through the
                kernel its plan picks, the grid kernel, and the cluster
                kernel at every cluster size the card accepts where the
                band fits
  4 main path   assemble, freeze, spmv (DIA kernel vs the CSR stream path),
                spmv_chain (the grid kernel at 2048², the cluster kernel on
                the 10⁴-row band at k = 1024, each against the CSR stream
                path), and 200 CG iterations through the kernels (the
                SpMV-dot and CG's two step kernels) and through the plain
                versions (the plain SpMV and CG's body of PyTorch ops and
                selects); launch counters must be > 0; the true residual
                in f64 on the host; one CG step of the two step kernels
                against its plain version on a random 2048² f32 state,
                active, and stopped by rr and by k (bitwise unchanged)
  5 converge    CG on the 512² system to rtol 1e-5
  6 determinism spmv, spmv_dot and the 200-iteration CG rerun bitwise
  7 times       the DIA SpMV on the 2^24-row band and at 2048², and the
                SpMV with its dot at 2048² in f32 and f64: each in three
                measured calls (CUDA events, their spread) between two of
                the plain version, its device time, the plan's picks (V,
                tile, compiled count, grid, edge tiles) and torch.mv (+
                torch.dot) on the CSR; one spmv_dot call launches one
                device kernel; CG's update and direction kernels, each
                kernel's device time a call inside a CG step against its
                plain version and its bound, and the 2048² solve in ms a
                step through the kernels and through CG's body of PyTorch
                ops, in turns; CG iterations/s, kernels vs plain; the
                10⁴-row k = 1024 chain on the cluster and the grid kernel
                in turns (f32 and f64), µs per step against the bound,
                the cluster kernel's device time, and a sweep of cluster
                sizes 1–16 and CTAs of the plan's size and of 128–1,024
                threads, each checked against the plain chain
  8 dia dtypes  the DIA kernels on bf16, f16 and f32-matrix × f64-x operands
                against their plain versions
  9 strip       the row-group SpMV through spmv of a StripELL against its
                plain version and its plan's walk, f32, f64 and bf16 values:
                the JAX package's test shapes, rectangular 5000×900 and
                300×9000, a stored zero, an empty matrix, lidx_pack 1/2/4,
                group 1/16
 10 fem path    assemble the FEM operator, freeze to StripELL, its row-group
                plan (build seconds, MB, group size, lanes, segments), spmv
                (the kernel vs the CSR stream path, and vs its plain version
                and its plan's walk at full size), spmm at m = 128 (one
                strip_spmm launch of the row-group SpMM over the same plan,
                against the CSR SpMM), PCG(Jacobi),
                PCG(block-Jacobi 64), BiCGStab, GMRES(30), Chebyshev,
                Jacobi, BiCGStab and GMRES on a
                nonsymmetric variant, f64 refinement over f32 PCG; the strip
                launch counter must be > 0; true residuals in f64 on the host
 11 determinism strip spmv and the PCG(Jacobi) run rerun bitwise
 12 times       strip SpMV vs plain with CUDA events (per call, dispatch
                included) and the kernel's device time (profiler), GB/s of
                the plan, x and y, and PCG(Jacobi) iterations/s through the
                kernel and the plain version
 13 route       the merge-path route kernel against its plain version (the
                two table halves) and bitwise against the walk of its plan in
                its order, at the default tile and at tiles of 8 and 16
                items (rows spanning 2 and more tiles), reruns bitwise, the
                plan equal to the CSR, f32, f64 and bf16 values: the JAX
                package's test shapes, heavy Zipf rows, a stored zero,
                rectangular 300×250, empty 5×7, 3×3, a layout with two
                splits, and a row of 3,500 entries
 14 circuit     the circuit path at full size: save_mtx / load_mtx (the C++
                parser), to_route, a RouteStream checkpoint reloaded to the
                card (its spmv bitwise equal), spmv vs the CSR stream path,
                BiCGStab, GMRES(30), Jacobi on the nonsymmetric operator and
                PCG(Jacobi) on a symmetric variant, true residuals in f64 on
                the host; spmm at m = 16 (the row-group SpMM over the G = 1
                plan) vs the CSR SpMM; the route_spmv and route_spmm launch
                counters must be > 0; the
                kernel vs its plain version and the walk at full size, f32
                and f64
 15 determinism route spmv and the BiCGStab run rerun bitwise
 16 times       the route SpMV vs its plain version (CUDA events, per call)
                and its device time (profiler), against its bound,
                torch.mv and the row-group SpMV over the same G = 1 plan;
                its device time at five tile sizes; the merge split (tiles,
                spanning rows, longest span); launches per BiCGStab
                iteration; BiCGStab iterations/s through the kernel and the
                plain version, and the host seconds of the path's steps
 17 bsr         the row-group SpMM kernel through spmm of a BSR against
                its plain version, f32, f64 and bf16 blocks: the JAX
                package's test shapes (64×256 m = 64, 100×300 m = 129),
                empty block rows, blocks 8/16/512 × 128/256, a stored zero,
                m = 0, nnz = 0; from_csr_device against the host freeze
 18 slab        the row-group SpMV and SpMM kernels through spmv and spmm
                against their plain versions, f32, f64 and bf16 values, m = 1, 5,
                17, 128, 129: SlabELL at rb 128 and 256, SlabPack with and
                without spill (an overflow pack), a rectangular matrix, an
                empty one, a stored zero; where B holds inf or NaN, the
                SpMM of a BSR and of a SlabELL against scipy's CSR SpMM
 19 fem spmm    the SpMM path at full size: BSR.from_csr_device(512×128) →
                its row-group plan (build seconds, MB, group size, padding)
                → spmm (Y[:256, :8] against scipy, as the reference
                benchmark checks), to_slab_pack and to_slab → their plans
                (one plan each for spmv and spmm; lanes and segments of the
                SpMV) → spmv and spmm, each kernel against its plain version
                and the plan's walk, against the strip kernel, the CSR
                stream path and the CSR spmm branch; a SlabPack checkpoint
                reloaded to the card; the bsr_spmm, slab_spmv and slab_spmm
                launch counters must be > 0; BSR spmm, SlabPack spmv and
                spmm rerun bitwise, and SlabPack and SlabELL spmv are
                bitwise equal; the StripELL's SpMM at m = 1, 8, 32, 128
                (sub-warps of 1, 2, 8 lanes a group, then whole warps):
                kernel and device ms against portbench's roofline bound,
                the plan's walk and torch.sparse.mm, every launch counted
                under its lane width
 20 times       each kernel of the path against its plain version (CUDA
                events per call, dispatch included) and its device time
                (profiler): the SpMM of the BSR, SlabPack and SlabELL
                in Tflop/s of 2·nnz·m and GB/s of the plan, B and
                Y, and through the SlabPack at m = 1, 17, 129 and in f64
                beside torch.sparse.mm, SlabPack and SlabELL SpMV in GB/s of
                the plan, x and y and of spmv_traffic_bytes beside the strip
                SpMV; the host seconds of the freezes and plans
 21 well        the row-group SpMV through spmv of a WELL against its plain
                version, f32, f64 and bf16 values: tests/test_well.py's
                matrices (random 300², wide 64×1000, tall 1000×64, empty
                rows, a dense row), k_tile = 4 overflow tiles, a stored
                zero, nnz = 0, a heavy row cut into many segments (against
                the plan's walk, reruns bitwise), empty groups; where x
                holds inf or NaN, the SpMV of a WELL, a SlabELL and a
                SlabPack against scipy's CSR SpMV
 22 slab stream the row-group SpMV through spmv of a SlabStream against its
                plain version and its plan's walk, f32, f64 and bf16 values:
                mixed-degree 2000 at rb 256 and 1100 at rb 128, rectangular
                300×900 and 900×300, an empty matrix, a stored zero
 23 general     the general-matrix path at full size: the circuit operator
                via save_mtx / load_mtx and a WELL checkpoint, both loaded
                with no device named (they must land on the card), → WELL →
                its plan (build seconds, MB, group size, lanes, segments) →
                spmv against the CSR stream path and the plan's walk,
                method='pallas' and the reloaded WELL bitwise equal,
                BiCGStab and GMRES(30) through the row-group SpMV, rmatvec against scipy's Aᵀy; the FEM SPD
                operator of phase 10 → SlabStream → its plan → spmv against
                the CSR stream path and the plan's walk, bitwise equal to
                the spmv over the StripELL and the SlabPack of the same CSR
                (one plan), PCG(Jacobi) over SlabStream and over StripELL
                bitwise equal (iterate and iteration count), a SlabStream
                checkpoint reloaded; auto_format picks DIA, StripELL and
                RouteStream for the Poisson, FEM and circuit operators; each
                kernel against its plain version at full size, f32 and f64;
                the well_spmv and slab_stream_spmv launch counters must be
                > 0; WELL spmv, SlabStream spmv, rmatvec and BiCGStab rerun
                bitwise
 24 times       the WELL and SlabStream SpMVs against their plain versions
                (CUDA events per call, dispatch included) and their device
                time (profiler), GB/s of the plan, x and y and of
                spmv_traffic_bytes, BiCGStab iterations/s through the
                row-group SpMV over WELL and PCG(Jacobi) iterations/s over
                SlabStream (against the plain versions), the host seconds of
                to_well, to_slab_stream, to_slab_pack and the plans
 25 algebra     on the FEM operator (CSR, f32): transpose, add(A, A.T),
                sub(A, A.T) and A - A against scipy on the host (structure
                and values equal, after pruning padding and zeros);
                is_symmetric of the FEM operator, the circuit operator and
                the circuit operator with one value moved; is_sorted,
                extract_row; the seconds of each call (CUDA events)
 26 spgemm      the circuit operator's A·A, which its 3,751-entry row sends
                down the ESC path (expand, sort, compress): against scipy's
                A @ A (structure after pruning zeros, values within rel
                1e-5), rerun bitwise; cold and warm seconds, M out-nnz/s,
                scipy's host seconds and torch.sparse.mm of the CUDA CSR
                tensor (a yardstick, used by no path; its failure is printed)
 27 spgemm fem  the FEM operator's A·A at full size, 547,534,650 candidates
                in row-aligned parts: the probe C·v against A·(A·v) through
                spmv (rel 1e-4), rerun bitwise; the plan's seconds apart
                from the expand/sort/compress seconds, cold and warm, output
                nse, M out-nnz/s, parts and part size, peak device memory,
                the torch.sparse.mm yardstick
 28 sor         the level schedule of the FEM SPD operator of phase 10; one
                Gauss-Seidel sweep against a row-by-row sweep in f64 on the
                host (rel 1e-5); 20 sweeps as a smoother (ms a sweep, device
                kernels a sweep from the profiler, the true residual in f64
                on the host), rerun bitwise; SOR at omega 1.9 on 128² Poisson
                in f64 to rtol 1e-6 on the card and on the CPU path of the
                port (equal iteration counts, iterates within rel 1e-5),
                rerun bitwise; and the seconds of phases 25-28
 29 partition   PartitionedBuilder (4 blocks) assembles the 2048² Poisson
                operator, its CSR on the card bitwise equal to SparseBuilder's;
                make_mesh() on the card (a world of one rank under NCCL) and
                process_info(); dryrun_multichip(1), the JAX package's six
                multichip checks, on the card
 30 dist        the distribution layer at a world of one: DistDIA on the 2048²
                Poisson operator (SpMV against spmv(DIA) and the plain DIA
                SpMV; 200 CG iterations against phase 4's CG, the true
                residual in f64 on the host; iterations/s in turns with phase
                4's CG), DistCSR, DistELL, DistCSRSubset and DistSlab (rb 128)
                on the FEM SPD operator of phase 10 (SpMV against spmv(CSR)
                and scipy; 200 CG iterations through DistSlab and
                DistCSRSubset against the CG over the CSR); each shard product
                against its plain version (the plain DIA SpMV, the walk of
                the shard's plan, the plain slab SpMV); every distributed
                SpMV and CG rerun bitwise; the dia_spmv, slab_spmv and dist_*
                launch counters must grow; the host seconds of each
                distribute_* and of its plan; each shard product timed
                against its plain version, its bound and torch.mv
Phases 25-28 run no CUDA kernel of the port: SpGEMM, the algebra and the
SOR sweep are PyTorch ops on the card, as the reference has no TPU kernel
there.
Every kernel's timing phase also times one PyTorch library call that
computes the same function on the same operator (torch.mv or
torch.sparse.mm on a torch.sparse_csr_tensor; none for spmv_dot, the
chain and CG's step kernels), as a yardstick only; computes the kernel's
bound: the larger of the bytes the function needs over 3.35 TB/s and its
f32 operations over 67 Tflop/s (the H100 SXM's published rates), where a
sparse product needs its entries in CSR (value and column index, row
pointers), x or B once and y or Y once, and a DIA band its diagonals, x and
y (an SpMV over a row-group plan smaller than the CSR is bound by the
plan's bytes, x and y instead: the FEM plan shares each column among 3
rows); and measures the kernel's launches per step of its path (per solver
iteration, or per product), from the launch counts over k and 2k steps.
Then a JSON line of the kernels and, last, the device JSON line.

``python3 chip_smoke.py --profile`` runs instead a torch.profiler trace of
64 CG iterations through the kernels at 512² and 2048², of 64 PCG(Jacobi)
iterations on the FEM StripELL and SlabStream and of 64 BiCGStab iterations
on the circuit RouteStream (the merge-path kernel) and of 64 CG iterations
through DistDIA at 2048² (a world of one rank under NCCL, its collectives
included), and prints the device time per iteration by
kernel (and of each path's SpMV kernel on a line of its own), the device
kernels launched per iteration and the device's busy share of wall time.

Tolerances (relative to max|reference|): f32 y 1e-5 (the same sums,
rounded with and without fused multiply-add, and for the row-group and
route kernels in another order: the route kernel sums each row in merge
order where its plain version differences a prefix sum of the routed
products), f32 dot 1e-4 (another summation order), f64 1e-12.  The route
kernel is also held bitwise to the walk of its plan, which replays its
order (it rounds each product before adding it, so no fused multiply-add
comes between them).  bf16 and f16 operands are widened to f32 by
both versions and held to the f32 tolerance.  Matrix products run in full
f32 (TF32 is switched off below).
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import checkpoint, matgen, parallel, solvers
from sparsemat_tpu_torch import io as tio
from sparsemat_tpu_torch.kernels import _rowgroup as krg
from sparsemat_tpu_torch.kernels import dia as kd
from sparsemat_tpu_torch.kernels import krylov as kk
from sparsemat_tpu_torch.kernels import route as kr
from sparsemat_tpu_torch.kernels import slab as ksl
from sparsemat_tpu_torch.kernels import spmm as ksp
from sparsemat_tpu_torch.kernels import strip as ks
from sparsemat_tpu_torch.kernels import well as kw
from sparsemat_tpu_torch.native import get_lib
from sparsemat_tpu_torch.ops import matvec as tmv
from sparsemat_tpu_torch.parallel import dist as pdist
from sparsemat_tpu_torch.parallel.dryrun import dryrun_multichip

#: kernel → (its source, the TPU kernel it replaces)
_DIA_CU = "sparsemat_tpu_torch/csrc/dia.cu"
_SPMV_CU = "sparsemat_tpu_torch/csrc/spmv.cu"
_KRYLOV_CU = "sparsemat_tpu_torch/csrc/krylov.cu"
KERNELS = {"dia_spmv": (_DIA_CU, "sparsemat_tpu/kernels/dia.py:76"),
           "dia_spmv_dot": (_DIA_CU, "sparsemat_tpu/kernels/dia.py:305"),
           "dia_spmv_chain": (_DIA_CU, "sparsemat_tpu/kernels/dia.py:202"),
           "dia_spmv_chain_cluster": (_DIA_CU, "sparsemat_tpu/kernels/dia.py:202"),
           "strip_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/strip.py:42"),
           "route_spmv": ("sparsemat_tpu_torch/csrc/route.cu",
                          "sparsemat_tpu/kernels/route.py:102, sparsemat_tpu/kernels/route.py:198"),
           "bsr_spmm": ("sparsemat_tpu_torch/csrc/spmm.cu",
                        "sparsemat_tpu/kernels/spmm.py:72"),
           "slab_spmv": (_SPMV_CU,
                         "sparsemat_tpu/kernels/spmv.py:165, sparsemat_tpu/kernels/spmv.py:271"),
           "slab_spmm": ("sparsemat_tpu_torch/csrc/spmm.cu",
                         "sparsemat_tpu/kernels/spmm.py:204, sparsemat_tpu/kernels/spmm.py:301"),
           "well_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:50"),
           "slab_stream_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:320"),
           # the row-partitioned shard products (phases 29-30): the same two
           # kernels, each launched once a distributed SpMV over the rank's block
           "dist_dia_spmv": (_DIA_CU, "sparsemat_tpu/kernels/dia.py:76"),
           "dist_csr_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:50"),
           "dist_ell_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:50"),
           "dist_csr_subset_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:50"),
           "dist_slab_spmv": (_SPMV_CU, "sparsemat_tpu/kernels/spmv.py:165"),
           # CG's step algebra: the XLA fusions of the reference's CG body
           "cg_update": (_KRYLOV_CU, "sparsemat_tpu/solvers.py:132-137 (XLA fusions)"),
           "cg_direction": (_KRYLOV_CU, "sparsemat_tpu/solvers.py:138-139 (XLA fusions)")}
TOL = {torch.float32: {"y": 1e-5, "dot": 1e-4}, torch.float64: {"y": 1e-12, "dot": 1e-12},
       torch.bfloat16: {"y": 1e-5, "dot": 1e-4}, torch.float16: {"y": 1e-5, "dot": 1e-4}}
SEED = 0
#: solves of the FEM and circuit paths: relative tolerance, and the bound on
#: the true relative residual (f64, host) each converged solve must meet
SOLVE_RTOL = 1e-5
SOLVE_TRUE_REL = 1e-4
#: the circuit path's launch keys (the plan group's RouteStream products)
ROUTE_KEYS = ("route_spmv", "route_spmm")
#: the H100 SXM's published device-memory rate and f32 rate outside the
#: tensor cores (the kernels' f32 arithmetic): the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

MAX_ABS = {name: 0.0 for name in KERNELS}
#: the candidate products of the FEM operator's A·A (counted with numpy)
FEM_CANDIDATES = 547_534_650


T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{phase}] {msg} ({time.perf_counter() - T0:.1f} s)", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def compare(kernel, got, want, tol, what):
    """Relative error of ``got`` against ``want``.  ``kernel`` names the
    kernel whose max abs error vs its plain version this comparison feeds
    (None for end-to-end comparisons)."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    rel = abs_err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    if kernel is not None:
        MAX_ABS[kernel] = max(MAX_ABS[kernel], abs_err)
    check(rel <= tol, f"{what}: rel err {rel:.3e} > {tol:.0e}")
    return rel


def gen(device):
    return torch.Generator(device=device).manual_seed(SEED)


def averaging_dia(n_rows, n_cols, offs, dtype, g):
    """A DIA with random nonnegative weights, each row summing to 1 (zero
    outside the matrix), so Aᵏx stays bounded for any k."""
    data = torch.rand(len(offs), n_rows, generator=g, dtype=torch.float64, device=g.device)
    i = torch.arange(n_rows, device=g.device)
    for d, o in enumerate(offs):
        data[d][(i + o < 0) | (i + o >= n_cols)] = 0
    data = data / data.sum(0).clamp_min(1e-30)
    return tsm.DIA(data=data.to(dtype).contiguous(), offsets=tuple(offs),
                   shape=(n_rows, n_cols))


def averaging_band(n, offs, seed):
    """An n-row band as a scipy CSR (f32) with random nonnegative weights,
    each row summing to 1: the operator of the reference benchmark's
    banded_1e4 chain, bounded for any k."""
    w = np.random.default_rng(seed).random((len(offs), n))
    i = np.arange(n)
    for d, o in enumerate(offs):
        w[d][(i + o < 0) | (i + o >= n)] = 0
    w /= w.sum(0)
    # scipy's diagonal o starts at row max(0, -o)
    diags = [w[d][max(0, -o):n - max(0, o)] for d, o in enumerate(offs)]
    return sp.diags(diags, offs, shape=(n, n), format="csr").astype(np.float32)


#: each chain kernel's row in the kernels JSON line
CHAIN_NAME = {"grid": "dia_spmv_chain", "cluster": "dia_spmv_chain_cluster"}


def chain_plans(A, dtype, threads=(None,)):
    """The chain plans held against the plain chain: the grid kernel, and
    the cluster kernel at every cluster size the card accepts where the
    band fits, at each CTA size of ``threads`` (None: the plan's own),
    each once."""
    n, n_d = A.shape[0], len(A.offsets)
    halo = sum(kd.chain_halos(A.offsets, n))
    smem, most = kd.cluster_limits(A.data.device, dtype)
    plans = [kd.grid_plan(A, dtype)]
    plans += [kd.cluster_plan(A, dtype, c, t) for t in threads for c in kd.CLUSTER_SIZES
              if c <= most and kd.cluster_smem(n, n_d, dtype.itemsize, c, halo) <= smem]
    return list({plan_label(p): p for p in plans}.values())


def plan_label(plan):
    if plan.kernel == "grid":
        return f"grid {plan.blocks} CTAs"
    return f"cluster {plan.blocks}×{plan.threads}"


#: CTA sizes of phase 7's sweep of the cluster chain
SWEEP_THREADS = (128, 256, 512, 1024)


def chain_counts():
    """Chain launches by kernel, under their names in the kernels JSON."""
    return {CHAIN_NAME[kern]: count for kern, count in kd.CHAIN_KERNELS.items()}


def chain_times(dev, g, times, nc=10_000, kc=1024, offs=(-100, -1, 0, 1, 100)):
    """Phase 7's chain: x ← Aᵏx on the 10⁴-row band at k = 1024, the
    cluster kernel (its plan's pick) and the grid kernel in turns, f32 and
    f64, the plain chain in f32, the cluster kernel's device time, and a
    sweep of every cluster size the card accepts and of CTA sizes.  Adds
    both kernels' rows to ``times``."""
    n_d = len(offs)
    for dtype in (torch.float32, torch.float64):
        chain = averaging_dia(nc, nc, offs, dtype, g)
        xc = torch.randn(nc, generator=g, dtype=dtype, device=dev)
        grid = kd.grid_plan(chain, dtype)
        picked = kd.dia_chain_plan(chain, dtype)
        check(picked.kernel == "cluster", f"the 10^4 band's chain plan is {picked}")
        want = kd.dia_spmv_chain_ref(chain, xc, kc)
        for plan in (grid, picked):
            compare(CHAIN_NAME[plan.kernel], kd.dia_spmv_chain(chain, xc, kc, plan), want,
                    TOL[dtype]["y"], f"chain 10^4 k={kc} {dtype} {plan_label(plan)}")
        run = {p.kernel: (lambda p=p: kd.dia_spmv_chain(chain, xc, kc, p)) for p in (grid, picked)}
        # in turns: grid, cluster, cluster, grid
        c_ms, g_ms, c_runs, g_runs = paired_ms(run["cluster"], run["grid"], 20)
        name = str(dtype).replace("torch.", "")
        n_bytes, flops = (n_d + 2) * nc * dtype.itemsize, 2 * n_d * nc * kc
        b_ms, by = bound_ms(n_bytes, flops)
        if dtype == torch.float32:
            _, p_ms, _, p_runs = paired_ms(run["cluster"], lambda: kd.dia_spmv_chain_ref(
                chain, xc, kc), 20, plain_iters=3)
            record(times, "dia_spmv_chain", g_ms, p_ms, n_bytes, flops, None)
            record(times, "dia_spmv_chain_cluster", c_ms, p_ms, n_bytes, flops, None)
            c_dev = device_us(run["cluster"], 20, "dia_chain_cluster_kernel",
                              lambda: kd.CHAIN_KERNELS["cluster"]) / 1e3
            g_dev = device_us(run["grid"], 20, "dia_chain_kernel",
                              lambda: kd.CHAIN_KERNELS["grid"]) / 1e3
            times["dia_spmv_chain_cluster"].update(
                device_ms=c_dev, cluster=picked.blocks, threads=picked.threads,
                smem_bytes=picked.smem)
            times["dia_spmv_chain"].update(device_ms=g_dev, ctas=grid.blocks)
            say("7 times", f"spmv_chain 10^4 rows {list(offs)} k={kc} {name}: cluster kernel "
                f"({plan_label(picked)}, {picked.threads} threads, {picked.smem} shared bytes a "
                f"CTA) {c_ms:.4f} ms ({c_ms / kc * 1e3:.3f} us/step) runs {c_runs}, device "
                f"{c_dev:.4f} ms; grid kernel ({grid.blocks} CTAs) {g_ms:.4f} ms "
                f"({g_ms / kc * 1e3:.3f} us/step) runs {g_runs}, device {g_dev:.4f} ms; plain "
                f"{p_ms:.4f} ms ({p_ms / kc * 1e3:.3f} us/step) runs {p_runs}; bound "
                f"{b_ms:.4f} ms ({by}, {b_ms / kc * 1e3:.5f} us/step)")
        else:
            times["dia_spmv_chain_cluster"].update(f64_ms=c_ms)
            times["dia_spmv_chain"].update(f64_ms=g_ms)
            say("7 times", f"spmv_chain 10^4 rows k={kc} {name}: cluster kernel "
                f"({plan_label(picked)}) {c_ms:.4f} ms ({c_ms / kc * 1e3:.3f} us/step) runs "
                f"{c_runs}; grid kernel {g_ms:.4f} ms ({g_ms / kc * 1e3:.3f} us/step) runs "
                f"{g_runs}; bound {b_ms:.4f} ms ({by})")
        # the sweep: each plan checked, then timed twice, forward then backward
        plans = [p for p in chain_plans(chain, dtype, (None,) + SWEEP_THREADS)
                 if p.kernel == "cluster"]
        for p in plans:
            compare("dia_spmv_chain_cluster", kd.dia_spmv_chain(chain, xc, kc, p), want,
                    TOL[dtype]["y"], f"chain 10^4 k={kc} {dtype} {plan_label(p)}")
        sweep = {plan_label(p): [] for p in plans}
        for p in plans + plans[::-1]:
            sweep[plan_label(p)].append(cuda_ms(lambda: kd.dia_spmv_chain(chain, xc, kc, p), 20))
        us = {lab: sum(v) / len(v) / kc * 1e3 for lab, v in sweep.items()}
        best = min(us, key=us.get)
        times["dia_spmv_chain_cluster"][f"sweep_us_per_step_{name}"] = us
        say("7 times", f"cluster chain sweep {name} (us/step, mean of two): "
            + "; ".join(f"{lab} {u:.4f}" for lab, u in us.items())
            + f"; fastest {best}; picked {plan_label(picked)}")


def three_ms(kernel_fn, plain_fn, iters, plain_iters=None):
    """Three measured timings of the kernel between two of its plain
    version (plain, kernel, kernel, kernel, plain), and their spread."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(plain_fn, plain_iters)
    runs = [cuda_ms(kernel_fn, iters) for _ in range(3)]
    p2 = cuda_ms(plain_fn, plain_iters)
    return runs, [p1, p2], (max(runs) - min(runs)) / min(runs)


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` launches, from a
    torch.profiler trace (``fn`` run once before, so nothing is built)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]


def plan_picks(plan):
    return {"vec": plan.vec, "tile": plan.tile, "tiles": plan.tiles, "n_d": plan.n_d,
            "grid": plan.grid, "interior": list(plan.interior), "edge_tiles": plan.edge_tiles,
            "near": list(plan.near), "far": list(plan.far)}


def dia_spmv_times(dev, g, times, dia, csr, nb=1 << 24):
    """Phase 7's SpMV rows: the SpMV (row 1) on the 2^24-row band and on
    the 2048² Poisson operator, and the SpMV with its dot (row 2) at 2048²
    in f32 and f64.  Each is held to its plain version, then timed in three
    measured calls between two of the plain version (CUDA events per call,
    dispatch included), with their spread, its device time (profiler), the
    plan's picks and, as an informative figure, the library's two calls
    torch.mv on the CSR and torch.dot.  One call of the dot launches one
    device kernel and nothing else.  Adds rows 1 and 2 to ``times``."""
    band = averaging_dia(nb, nb, (-4096, -1, 0, 1, 4096), torch.float32, g)
    xb = torch.randn(nb, generator=g, device=dev)
    m = dia.shape[0]
    xd = torch.randn(m, generator=g, device=dev)
    dia64 = tsm.DIA(data=dia.data.double(), offsets=dia.offsets, shape=dia.shape)
    csr_t = torch_csr(csr)
    csr64 = torch.sparse_csr_tensor(csr_t.crow_indices(), csr_t.col_indices(),
                                    csr_t.values().double(), csr_t.shape)
    band_t = torch_csr(band.to_csr())
    cases = [
        ("dia_spmv", f"spmv {nb}-row band [-4096,-1,0,1,4096] f32", band, xb, False, band_t),
        ("dia_spmv", "spmv 2048² Poisson f32", dia, xd, False, csr_t),
        ("dia_spmv_dot", "spmv_dot 2048² Poisson f32", dia, xd, True, csr_t),
        ("dia_spmv_dot", "spmv_dot 2048² Poisson f64", dia64, xd.double(), True, csr64),
    ]
    for name, label, A, x, with_dot, lib_csr in cases:
        dtype, n = x.dtype, A.shape[0]
        n_d = len(A.offsets)
        if with_dot:
            (yk, dk), (yp, dp) = kd.dia_spmv_dot(A, x), kd.dia_spmv_dot_ref(A, x)
            compare(name, yk, yp, TOL[dtype]["y"], f"{label} y")
            compare(name, dk, dp, TOL[dtype]["dot"], f"{label} dot")
            kernel_fn, plain_fn = (lambda: kd.dia_spmv_dot(A, x)), (lambda: kd.dia_spmv_dot_ref(A, x))
            lib_fn = lambda: torch.dot(torch.mv(lib_csr, x), x)
        else:
            compare(name, kd.dia_spmv(A, x), kd.dia_spmv_ref(A, x), TOL[dtype]["y"], label)
            kernel_fn, plain_fn = (lambda: kd.dia_spmv(A, x)), (lambda: kd.dia_spmv_ref(A, x))
            lib_fn = lambda: torch.mv(lib_csr, x)
        runs, p_runs, spread = three_ms(kernel_fn, plain_fn, 50 if n < nb else 20)
        k_ms, p_ms = sum(runs) / 3, sum(p_runs) / 2
        dev_ms = device_us(kernel_fn, 50, "dia_spmv_kernel", lambda: kd.LAUNCHES[name]) / 1e3
        lib = library_ms(lib_fn, 20)
        n_bytes = (n_d + 2) * n * dtype.itemsize
        flops = 2 * n_d * n + (2 * n if with_dot else 0)
        b_ms, by = bound_ms(n_bytes, flops)
        picks = plan_picks(kd.dia_spmv_plan(A, dtype, dev))
        entry = {"ms": k_ms, "runs_ms": runs, "spread": spread, "plain_ms": p_ms,
                 "device_ms": dev_ms, "bound_ms": b_ms, "plan": picks}
        if name not in times:
            # the table's rows: row 1 on the 2^24 band, row 2 at 2048² f32;
            # the dot has no single library call (torch.mv + torch.dot is two)
            record(times, name, k_ms, p_ms, n_bytes, flops, None if with_dot else lib)
            times[name].update(runs_ms=runs, spread=spread, device_ms=dev_ms, plan=picks)
            if with_dot:
                times[name]["mv_dot_ms"] = lib
        else:
            times[name][label] = dict(entry, library_two_calls_ms=lib) if with_dot else dict(
                entry, library_ms=lib)
        say("7 times", f"{label}: kernel {k_ms:.4f} ms ({n_bytes / 1e6 / k_ms:.1f} GB/s) runs "
            f"{[round(r, 4) for r in runs]} spread {100 * spread:.1f}%; device {dev_ms:.4f} ms "
            f"({n_bytes / 1e6 / dev_ms:.1f} GB/s, {b_ms / dev_ms:.1%} of the bound); plain "
            f"{p_ms:.4f} ms runs {[round(r, 4) for r in p_runs]}; bound {b_ms:.4f} ms ({by}); "
            f"{'torch.mv + torch.dot (two calls)' if with_dot else 'torch.mv'} on the CSR "
            f"{lib:.4f} ms; plan V={picks['vec']} T={picks['tile']} n_d={picks['n_d']} "
            f"grid={picks['grid']} of {picks['tiles']} tiles, edge tiles {picks['edge_tiles']}")
    one = device_kernels(lambda: kd.dia_spmv_dot(dia, xd))
    check(len(one) == 1 and "dia_spmv_kernel" in one[0],
          f"one spmv_dot call launched {one}, not the one SpMV kernel")
    say("7 times", f"one spmv_dot call launches one device kernel: {one[0][:90]}")


def poisson_triplets(n):
    """The n²-row 5-point Poisson operator as row-major sorted triplets."""
    m = n * n
    i = np.arange(m, dtype=np.int64)
    offs = np.array([-n, -1, 0, 1, n], np.int64)
    valid = np.stack([i >= n, i % n != 0, np.ones(m, bool), i % n != n - 1,
                      i < m - n], axis=1)
    cols = i[:, None] + offs[None, :]
    vals = np.where(offs == 0, 4.0, -1.0)[None, :].repeat(m, 0)
    rows = np.repeat(i, 5).reshape(m, 5)
    return rows[valid], cols[valid], vals[valid]


def assemble_poisson(n, device):
    t0 = time.perf_counter()
    b = tsm.SparseBuilder(5 * n * n)
    b.add_batch(*poisson_triplets(n))
    t1 = time.perf_counter()
    csr = b.to_csr(device=device)
    t2 = time.perf_counter()
    dia = csr.to_dia()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(b.native, "the builder is not using the C++ store")
    check(dia.offsets == (-n, -1, 0, 1, n), f"offsets {dia.offsets}")
    check(csr.n_non_zero_entries() == 5 * n * n - 4 * n, "nnz")
    return csr, dia, (t1 - t0, t2 - t1, t3 - t2)


def host_residual(csr, x, b):
    """‖b − A x‖ in f64 with scipy on the host."""
    import scipy.sparse as sp

    A = sp.csr_matrix((csr.host("data").astype(np.float64), csr.host("indices"),
                       csr.host("indptr")), shape=csr.shape)
    xb = x.double().cpu().numpy()
    bb = b.double().cpu().numpy()
    return float(np.linalg.norm(bb - A @ xb)), float(np.linalg.norm(bb))


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters, plain_iters=None):
    """Times in turns — plain, kernel, kernel, plain — so drift hits both
    (a slow plain version may take fewer iterations)."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(plain_fn, plain_iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, [k1, k2], [p1, p2]


def bound_ms(n_bytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes the function must move over the memory rate
    and its operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def need_bytes(nnz, shape, m=1, val_bytes=4):
    """The bytes a sparse product needs, whatever its layout: the stored
    entries in CSR (a value and a 4-byte column index each, a 4-byte row
    pointer per row), x (B, m columns) read once and y (Y) written once.
    A layout's padding, tiles and tables are the kernel's own cost, not the
    function's."""
    n_rows, n_cols = shape
    return nnz * (val_bytes + 4) + (n_rows + 1) * 4 + (n_rows + n_cols) * m * val_bytes


def record(times, name, k_ms, p_ms, n_bytes, flops, lib_ms):
    """A kernel's row of the kernels JSON line: its time and its plain
    version's, its bound from this run's inputs (``n_bytes`` the bytes the
    function needs, ``flops`` its operations), and the library call's."""
    b_ms, by = bound_ms(n_bytes, flops)
    times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                   "bound_bytes": n_bytes, "library_ms": lib_ms}
    return b_ms, by


def per_step(counts, run, k, operator=None):
    """Each kernel's launches per step of ``run`` (``run(j)`` takes j solver
    iterations, or makes j products): the rise of ``counts()`` over 2k steps
    less its rise over k, divided by k, so launches outside the loop cancel.
    The launch counters count host enqueues.  A solver loop over
    ``operator`` with no block graph yet enqueues its first block op by op
    and its second while capturing it, and a replay enqueues none: so the
    operator's graphs are dropped before each run, the k-step run (one
    block) is the op-by-op block and the 2k-step run adds the captured one."""
    rises = []
    for steps in (k, 2 * k):
        if operator is not None:
            operator.__dict__.pop("_solver_graphs", None)
        before = dict(counts())
        run(steps)
        torch.cuda.synchronize()
        rises.append({n: c - before[n] for n, c in counts().items()})
    return {n: (rises[1][n] - rises[0][n]) / k for n in rises[0]}


def note_steps(times, name, rate, what):
    """Add a kernel's launches per step of its path to its row of the JSON
    line (after ``record``)."""
    check(rate > 0, f"{what}: {name} launched no time per step")
    times[name].update(launches_per_step=rate, step=what)
    return rate


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def torch_csr(csr):
    """The operator as a torch.sparse_csr_tensor: the yardstick's operand,
    used by no path of the port."""
    nnz = csr.n_non_zero_entries()
    with warnings.catch_warnings():         # PyTorch's beta notice for sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(csr.indptr.long(), csr.indices[:nnz].long(),
                                       csr.data[:nnz], csr.shape)


def library_ms(fn, iters):
    """CUDA-event ms per call of one PyTorch library call: the yardstick of
    a kernel (torch.mv or torch.sparse.mm on the same operator).  A failure
    raises; rows with no single-call equivalent pass None instead."""
    return cuda_ms(fn, iters)


def cg_iters_per_s(A, b, iters, M=None):
    solvers.cg(A, b, tol=0.0, maxiter=32, M=M)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = solvers.cg(A, b, tol=0.0, maxiter=iters, M=M)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(int(info.iterations) == iters, "CG stopped early")
    return iters / dt


def plain_cg_iters_per_s(dia, b, iters):
    """``cg_iters_per_s`` of the plain CG: the body of PyTorch ops and
    selects over the plain SpMV."""
    with torch_body():
        return cg_iters_per_s(lambda v: kd.dia_spmv_ref(dia, v), b, iters)


@contextlib.contextmanager
def torch_body():
    """CG sent to its body of PyTorch ops and selects, in place of the step
    kernels of ``kernels/krylov.py``: the plain version of the fused body."""
    chosen = solvers._fused_reason
    solvers._fused_reason = lambda *a: "the plain version"
    try:
        yield
    finally:
        solvers._fused_reason = chosen


def cg_state(g, dia, dtype=torch.float32, share=0.0):
    """A random CG state over ``dia`` (x, r, p, A·p, pAp, rr, k, maxiter,
    thresh2): active where ``share`` (thresh2 over rr) is at most 1."""
    dev, n = dia.data.device, dia.shape[0]
    x, r, p = (torch.randn(n, generator=g, device=dev, dtype=dtype) for _ in range(3))
    Ap, pAp = tsm.spmv_dot(dia, p)
    rr = torch.dot(r, r)
    return dict(x=x, r=r, p=p, Ap=Ap, pAp=pAp, rr=rr, k=torch.zeros((), dtype=torch.int32,
                device=dev), maxiter=torch.tensor(2 ** 31 - 1, dtype=torch.int32, device=dev),
                thresh2=share * rr)


def plain_update(st):
    """The plain version of ``cg_update_kernel``: the update half of CG's
    body of PyTorch ops (z = r) and its commits."""
    active = (st["k"] < st["maxiter"]) & (st["rr"] >= st["thresh2"])
    alpha = torch.where(st["pAp"] != 0, st["rr"] / st["pAp"], 0)
    x, r = st["x"] + alpha * st["p"], st["r"] - alpha * st["Ap"]
    rr = torch.sum(r * r)
    beta = torch.where(st["rr"] != 0, rr / st["rr"], 0)
    return active, beta, dict(x=torch.where(active, x, st["x"]), r=torch.where(active, r, st["r"]),
                              rr=torch.where(active, rr, st["rr"]),
                              k=torch.where(active, st["k"] + 1, st["k"]))


def plain_direction(st, active, beta, r):
    """The plain version of ``cg_direction_kernel``: p = r + βp, committed
    where the step is active."""
    return torch.where(active, r + beta * st["p"], st["p"])


def kernel_step(st):
    """One launch pair of ``kernels/krylov.py`` on a copy of ``st``."""
    out = {k: st[k].clone() for k in ("x", "r", "p", "rr", "k")}
    kk.cg_step(out["x"], out["r"], out["p"], st["Ap"], st["pAp"], out["rr"], out["k"],
               st["maxiter"], st["thresh2"], *kk.step_scratch(st["x"].device))
    return out


def check_cg_step(g, dia):
    """Phase 4's step: the two step kernels against their plain versions on
    one random 2048² f32 state, active (x, r, rr and p at f32 rounding, k
    one up: a wrong α, β or flag fails), then stopped by rr < thresh2 and
    by k = maxiter (every value bitwise unchanged).  Returns the worst
    relative error of the active step."""
    st = cg_state(g, dia)
    got = kernel_step(st)
    active, beta, want = plain_update(st)
    want["p"] = plain_direction(st, active, beta, want["r"])
    check(int(got["k"]) == 1, f"the active step left k at {int(got['k'])}")
    errs = [compare("cg_update", got[key], want[key], TOL[torch.float32]["y"], f"cg_step {key}")
            for key in ("x", "r")]
    errs.append(compare("cg_update", got["rr"], want["rr"], TOL[torch.float32]["dot"],
                        "cg_step rr"))
    errs.append(compare("cg_direction", got["p"], want["p"], TOL[torch.float32]["y"],
                        "cg_step p"))
    for label, stopped in (("rr < thresh2", dict(st, thresh2=2 * st["rr"])),
                           ("k = maxiter", dict(st, maxiter=st["k"].clone()))):
        out = kernel_step(stopped)
        for key, v in out.items():
            check(torch.equal(v, stopped[key]), f"cg_step stopped by {label} changed {key}")
    return max(errs)


def cg_step_times(dev, g, times, dia, b, steps=64):
    """Phase 7's rows of the two step kernels at 2048² f32: each kernel's
    device time per call inside a CG step (SpMV-dot and the launch pair, op
    by op on an evolving state, from the profiler), its plain version's
    time (CUDA events on one fixed state), and its bound (the update reads
    x, p, r and A·p and writes x and r, 6n values; the direction reads r
    and p and writes p, 3n).  Also the whole solve in ms a step, the
    kernels against CG's body of PyTorch ops, both over the DIA kernel and
    through the operator's block graph, in turns."""
    st = cg_state(g, dia)
    work = kk.step_scratch(dev)
    # a CG from its first step (p = r), which no number of steps overflows
    live = {k: st[k].clone() for k in ("x", "r", "rr", "k")}
    live["p"] = live["r"].clone()

    def step():
        Ap, pAp = tsm.spmv_dot(dia, live["p"])
        kk.cg_step(live["x"], live["r"], live["p"], Ap, pAp, live["rr"], live["k"],
                   st["maxiter"], st["thresh2"], *work)

    def plain_halves():
        active, beta, out = plain_update(st)
        return plain_direction(st, active, beta, out["r"])

    n, item = dia.shape[0], st["x"].element_size()
    upd = plain_update(st)
    plain = {"cg_update": lambda: plain_update(st),
             "cg_direction": lambda: plain_direction(st, upd[0], upd[1], upd[2]["r"])}
    flops = {"cg_update": 6 * n, "cg_direction": 2 * n}
    for name, values in (("cg_update", 6), ("cg_direction", 3)):
        dev_ms = device_us(step, steps, f"{name}_kernel", lambda: kk.LAUNCHES[name]) / 1e3
        p_ms = cuda_ms(plain[name], 50)
        b_ms, by = record(times, name, dev_ms, p_ms, values * n * item, flops[name], None)
        times[name].update(device_ms=dev_ms, ms_from="device trace")
        say("7 times", f"{name} 2048² f32: device {dev_ms:.4f} ms a call ({b_ms / dev_ms:.1%} of "
            f"the bound); plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({by})")

    def solve_ms(fused):
        body = contextlib.nullcontext() if fused else torch_body()
        with body:
            return 1e3 / cg_iters_per_s(dia, b, 320)

    runs = [solve_ms(True), solve_ms(False), solve_ms(False), solve_ms(True)]
    whole = {"kernels_ms": [runs[0], runs[3]], "torch_body_ms": runs[1:3],
             "one_step_plain_ms": cuda_ms(plain_halves, 50)}
    times["cg_update"]["cg_step_ms"] = whole
    say("7 times", f"CG step 2048² f32 through the block graph: kernels {runs[0]:.4f}, "
        f"{runs[3]:.4f} ms a step; body of PyTorch ops {runs[1]:.4f}, {runs[2]:.4f} ms a step")


def build_all():
    """Build every native library at once (one compiler process each) and
    return the seconds each took; a failed build raises."""
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    jobs = {"csrc/dia.cu": kd._kernels, "csrc/route.cu": kr._kernels,
            "csrc/spmm.cu": krg._kernels, "csrc/spmv.cu": krg._spmv_kernels,
            "csrc/krylov.cu": kk._kernels,
            "C++ assembly store": get_lib}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        results = {name: f.result() for name, f in futs.items()}
    check(results["C++ assembly store"][0] is not None,
          "the C++ assembly library did not build")
    return {name: dt for name, (_, dt) in results.items()}


def banded_random(n, half_bw, density, seed, n_cols=None):
    """The JAX package's StripELL test matrices (tests/test_strip.py):
    random entries kept within ``half_bw`` of the diagonal."""
    rng = np.random.default_rng(seed)
    n_cols = n if n_cols is None else n_cols
    m = sp.random(n, n_cols, density, format="coo", dtype=np.float32, random_state=rng)
    keep = np.abs(m.row - m.col) <= half_bw
    return sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])),
                         shape=(n, n_cols)).tocsr()


def strip_cases():
    """(label, scipy matrix, to_strip kwargs) for the kernel-vs-plain phase."""
    zero = banded_random(800, 300, 0.02, 5)
    zero.data[[0, 17]] = 0.0                # stored entries whose value is zero
    rng = np.random.default_rng(4)
    cases = [(f"test_strip n={n} bw={bw}", banded_random(n, bw, d, seed), {})
             for n, bw, d, seed in ((3000, 1500, 0.004, 0), (1000, 400, 0.02, 1),
                                    (517, 517, 0.05, 2), (130, 40, 0.3, 3))]
    cases += [(f"rectangular {r}x{c}", sp.random(r, c, density=d, format="csr",
                                                 dtype=np.float32, random_state=rng), {})
              for (r, c), d in (((5000, 900), 0.01), ((300, 9000), 0.02))]
    cases += [("stored zero", zero, {}),
              ("empty", sp.csr_matrix((700, 500), dtype=np.float32), {})]
    wide = banded_random(6000, 1200, 0.01, 6)
    cases += [(f"lidx_pack={p} group={g}", wide, dict(lidx_pack=p, group=g))
              for p in (1, 2, 4) for g in (1, 16)]
    return cases


def fem_triplets(skew=0.0):
    """The pwtk-class surrogate ``matgen.fem_block_band()`` (217,920 rows,
    seed 0) with its diagonal set to Σ_j≠i |a_ij| + 1: symmetric and
    strictly diagonally dominant, hence SPD, with Gershgorin bounds
    [1, max_i(2 d_i − 1)].  ``skew`` adds a skew-symmetric band
    (+skew at (i, i+1), −skew at (i+1, i)), which keeps the symmetric part
    and makes the operator nonsymmetric.  Returns (rows, cols, vals, n,
    lambda_max)."""
    m = matgen.fem_block_band(seed=SEED).tocoo()
    n = m.shape[0]
    off = m.row != m.col
    r, c, v = m.row[off].astype(np.int64), m.col[off].astype(np.int64), m.data[off]
    d = np.bincount(r, weights=np.abs(v).astype(np.float64), minlength=n) + 1.0
    i = np.arange(n, dtype=np.int64)
    rows, cols, vals = [r, i], [c, i], [v, d.astype(np.float32)]
    if skew:
        j = i[:-1]
        rows += [j, j + 1]
        cols += [j + 1, j]
        vals += [np.full(n - 1, skew, np.float32), np.full(n - 1, -skew, np.float32)]
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n,
            float(2.0 * d.max() - 1.0))


def assemble_strip(rows, cols, vals, n, device):
    """SparseBuilder.add_batch → to_csr(device) → to_strip(), timed."""
    t0 = time.perf_counter()
    b = tsm.SparseBuilder(rows.size)
    b.add_batch(rows, cols, vals)
    t1 = time.perf_counter()
    csr = b.to_csr(device=device)
    t2 = time.perf_counter()
    st = csr.to_strip()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(b.native, "the builder is not using the C++ store")
    check(csr.shape == (n, n), f"shape {csr.shape}")
    return csr, st, (t1 - t0, t2 - t1, t3 - t2)


def true_rel(csr, x, b):
    r, bn = host_residual(csr, x, b)
    return r / bn


def device_us(fn, iters, key, launched):
    """Device µs per call of the kernels whose name holds ``key``, from a
    torch.profiler trace of ``iters`` calls of ``fn``: the mean time per
    recorded launch times the launches per call, which ``launched`` (a
    launch counter) gives.  The profiler can drop the records of
    long kernels late in a process (two of five 10 ms launches recorded
    in one run, none of twenty short ones in another), so a shortfall is
    printed and not taken as zero time, and a trace that recorded nothing
    is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        before = launched()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        made = launched() - before
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
        us = sum(e.self_device_time_total for e in rows)
        recorded = sum(e.count for e in rows)
        if us > 0 and recorded > 0:
            break
        say("profile", f"{key}: the profiler recorded none of {made} launches (trace "
            f"{attempt + 1} of 3)")
    check(us > 0 and recorded > 0, f"the profiler recorded no device time for {key}")
    if recorded != made:
        say("profile", f"{key}: the profiler recorded {recorded} of {made} launches; "
            "device time per call is the mean per recorded launch")
    return us / recorded * made / iters


def profile_solvers(dev, iters=64):
    """Device time per solver iteration by kernel, and the device's busy
    share of the wall time with and without the profiler: CG on the 512²
    and 2048² Poisson DIA, PCG(Jacobi) on the FEM StripELL and SlabStream
    (one row-group plan), BiCGStab on the circuit RouteStream, and CG at
    2048² through DistDIA at a world of one rank under NCCL and over its
    plain block with no DTensor.  Each
    case's SpMV kernels (the names holding its key) get a line of their
    own."""
    from torch.profiler import ProfilerActivity, profile

    cases = []
    for n in (512, 2048):
        csr, dia, _ = assemble_poisson(n, dev)
        b = tsm.spmv(csr, torch.randn(n * n, generator=gen(dev), device=dev))
        cases.append((f"CG {n}²", "dia_spmv",
                      lambda k, A=dia, b=b: solvers.cg(A, b, tol=0.0, maxiter=k)))
    # the same 2048² CG through DistDIA at a world of one rank under NCCL
    mesh = parallel.make_mesh()
    dA = parallel.distribute_dia(dia, mesh)
    bs = dA.padded_vector(b, mesh)
    cases.append(("DistDIA CG 2048² (world of one, NCCL)", "dia_spmv",
                  lambda k: solvers.cg(lambda v: dA.matvec(v, mesh), bs, tol=0.0, maxiter=k)))
    cases.append(("CG 2048² over DistDIA's plain block (no DTensor)", "dia_spmv",
                  lambda k: solvers.cg(block_matvec(dA), bs.to_local(), tol=0.0, maxiter=k)))
    rows, cols, vals, n, _ = fem_triplets()
    csr, st, _ = assemble_strip(rows, cols, vals, n, dev)
    Mj = solvers.JacobiPreconditioner.from_matrix(csr)
    b = torch.randn(n, generator=gen(dev), device=dev)
    for label, A in (("StripELL", st), ("SlabStream", csr.to_slab_stream())):
        cases.append((f"PCG(Jacobi) fem {label}", "rowgroup_spmv_kernel",
                      lambda k, A=A, b=b: solvers.cg(A, b, tol=0.0, maxiter=k, M=Mj)))
    rs = tsm.CSR.from_scipy((matgen.circuit_scatter(seed=SEED) * 2e-2).tocsr(),
                            device=dev).to_route()
    b = torch.randn(rs.shape[0], generator=gen(dev), device=dev)
    cases.append(("BiCGStab circuit RouteStream", "route_spmv_kernel",
                  lambda k, b=b: solvers.bicgstab(rs, b, tol=0.0, maxiter=k)))
    for label, key, solve in cases:
        solve(4)                        # builds the launch plan outside the timing
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(iters)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6 / iters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(iters)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / iters
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kern) / iters
        check(dev_us > 0, "the profiler recorded no device time")
        spmv_us = sum(e.self_device_time_total for e in kern if key in e.key) / iters
        per_iter = sum(e.count for e in kern) / iters
        say("profile", f"{label}: wall us/iter unprofiled {walls}, profiled {wall}; "
            f"device us/iter {dev_us}, of it {spmv_us} in the kernels named *{key}*; "
            f"{per_iter:.2f} device kernels per iteration; busy "
            f"share of unprofiled wall {dev_us / min(walls)}, of profiled wall {dev_us / wall}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:14]:
            print(f"   {e.self_device_time_total / iters:9.2f} us/iter  "
                  f"x{e.count / iters:5.2f}/iter  {e.key[:110]}", flush=True)
    torch.distributed.destroy_process_group()


def fem_phases(dev, g, times, launches):
    """Phases 8–12: the DIA dtype repair, the strip kernel against its
    plain version, and the FEM path.  Adds the strip kernel's times and
    main-path launches to ``times`` and ``launches``."""
    # 8 ------------------------------------------------------------------------
    worst = {}
    A = averaging_dia(100_001, 100_001, (-300, -1, 0, 1, 300), torch.float32, g)
    x32 = torch.randn(100_001, generator=g, device=dev)
    for label, dt_mat, dt_x in (("bf16", torch.bfloat16, torch.bfloat16),
                                ("f16", torch.float16, torch.float16),
                                ("f32 matrix, f64 x", torch.float32, torch.float64)):
        Ad = tsm.DIA(data=A.data.to(dt_mat), offsets=A.offsets, shape=A.shape)
        xd = x32.to(dt_x)
        tol = TOL[torch.promote_types(dt_mat, dt_x)]
        y = kd.dia_spmv(Ad, xd)
        y_ref = kd.dia_spmv_ref(Ad, xd)
        check(y.dtype == y_ref.dtype, f"{label}: kernel dtype {y.dtype} vs {y_ref.dtype}")
        errs = [compare("dia_spmv", y, y_ref, tol["y"], f"dia_spmv {label}")]
        (yd, d), (yd_ref, d_ref) = kd.dia_spmv_dot(Ad, xd), kd.dia_spmv_dot_ref(Ad, xd)
        errs.append(compare("dia_spmv_dot", yd, yd_ref, tol["y"], f"dia_spmv_dot y {label}"))
        errs.append(compare("dia_spmv_dot", d, d_ref, tol["dot"], f"dia_spmv_dot dot {label}"))
        for k in (1, 5):
            yc = kd.dia_spmv_chain(Ad, xd, k)
            yc_ref = kd.dia_spmv_chain_ref(Ad, xd, k)
            check(yc.dtype == yc_ref.dtype, f"{label}: chain dtype {yc.dtype}")
            errs.append(compare("dia_spmv_chain", yc, yc_ref, tol["y"],
                                f"dia_spmv_chain k={k} {label}"))
        worst[f"{label} → {y.dtype}"] = max(errs)
    torch.cuda.synchronize()
    say("8 dia dtypes", "kernels vs plain within tolerance; worst rel err: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items()))

    # 9 ------------------------------------------------------------------------
    worst = {}
    for label, m, kw in strip_cases():
        st = tsm.CSR.from_scipy(m, device=dev).to_strip(**kw)
        check(st.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        xs = torch.randn(m.shape[1], generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            s_dt = st.astype(dt)
            x_dt = xs.to(torch.float32 if dt == torch.bfloat16 else dt)
            y = tsm.spmv(s_dt, x_dt)
            y_ref = ks.strip_spmv_ref(s_dt, x_dt)
            check(y.dtype == y_ref.dtype, f"{label}: dtype {y.dtype} vs {y_ref.dtype}")
            errs.append(compare("strip_spmv", y, y_ref, TOL[dt]["y"], f"strip {label} {dt}"))
            compare(None, y, krg.spmv_walk(krg.plan_of(s_dt), x_dt), TOL[dt]["y"],
                    f"strip {label} {dt} vs its plan's walk")
        worst[label] = max(errs)
    torch.cuda.synchronize()
    say("9 strip", "kernel vs plain and vs its plan's walk within tolerance (f32, f64, "
        "bf16 values); worst rel err vs plain per case: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items()))

    # 10 -----------------------------------------------------------------------
    t0 = time.perf_counter()
    rows, cols, vals, n, lam_max = fem_triplets()
    t_gen = time.perf_counter() - t0
    krg.reset_launches()
    csr, st, (t_add, t_csr, t_strip) = assemble_strip(rows, cols, vals, n, dev)
    del rows, cols, vals
    t0 = time.perf_counter()
    plan = krg.plan_of(st)                  # what the first spmv would build
    plan.spmv
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    x = torch.randn(n, generator=g, device=dev)
    y_st = tsm.spmv(st, x)
    e_spmv = compare(None, y_st, tsm.spmv(csr, x), 1e-5, "fem spmv strip kernel vs CSR stream")
    e_walk = compare(None, y_st, krg.spmv_walk(plan, x), 1e-5,
                     "fem strip kernel vs its plan's walk")
    B128 = torch.randn(n, 128, generator=g, device=dev)
    Y_st = tsm.spmm(st, B128)               # the row-group SpMM over the same plan
    torch.cuda.synchronize()
    check(krg.LAUNCHES["strip_spmm"] == 1, f"spmm(StripELL) launched strip_spmm "
                                          f"{krg.LAUNCHES['strip_spmm']} times, not once")
    e_spmm = compare(None, Y_st, tsm.spmm(csr, B128), 1e-5,
                     "fem spmm strip kernel vs the CSR SpMM, m = 128")
    del B128, Y_st
    b = torch.randn(n, generator=g, device=dev)
    Mj = solvers.JacobiPreconditioner.from_matrix(csr)
    report = {}

    def solved(label, x_, info, A_csr, b_):
        rel = true_rel(A_csr, x_, b_)
        check(bool(info.converged), f"{label} did not converge in {int(info.iterations)}")
        check(rel <= SOLVE_TRUE_REL, f"{label}: true relative residual {rel:.3e} > {SOLVE_TRUE_REL}")
        report[label] = (int(info.iterations), rel)

    x_pcg, info_pcg = solvers.cg(st, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000, M=Mj)
    solved("PCG(Jacobi)", x_pcg, info_pcg, csr, b)
    Mb = solvers.BlockJacobiPreconditioner.from_matrix(csr, block_size=64)
    solved("PCG(block-Jacobi 64)",
           *solvers.cg(st, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000, M=Mb), csr, b)
    solved("BiCGStab", *solvers.bicgstab(st, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000), csr, b)
    solved("GMRES(30)", *solvers.gmres(st, b, tol=0.0, rtol=SOLVE_RTOL, restart=30,
                                       maxiter=3000), csr, b)
    solved("Chebyshev", *solvers.chebyshev(st, b, lambda_min=1.0, lambda_max=lam_max, tol=0.0,
                                           rtol=SOLVE_RTOL, maxiter=5000), csr, b)
    solved("Jacobi", *solvers.jacobi(st, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=5000), csr, b)

    # f32 PCG run far past where it stalls, then refinement: f64 residuals
    # through the f64 strip kernel steer f32 inner PCG solves
    x32s, _ = solvers.cg(st, b, tol=0.0, rtol=1e-12, maxiter=600, M=Mj)
    stall = true_rel(csr, x32s, b)
    b64 = b.double()
    x_ref, info_ref = solvers.refine(st.astype(torch.float64), b64, tol=0.0, rtol=1e-12,
                                     A_low=st, M=Mj, inner_rtol=1e-2)
    refined = true_rel(csr, x_ref, b64)
    check(refined < stall, f"refine's true residual {refined:.3e} is not below f32 PCG's "
                           f"{stall:.3e}")

    nrows, ncols, nvals, _, _ = fem_triplets(skew=1.0)
    csr_ns, st_ns, _ = assemble_strip(nrows, ncols, nvals, n, dev)
    del nrows, ncols, nvals
    sym = tsm.spmv(st_ns, x) - tsm.spmv(st, x)
    check(float(sym.abs().max()) > 0.1, "the skew band made no difference")
    solved("BiCGStab nonsymmetric",
           *solvers.bicgstab(st_ns, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000), csr_ns, b)
    solved("GMRES(30) nonsymmetric",
           *solvers.gmres(st_ns, b, tol=0.0, rtol=SOLVE_RTOL, restart=30, maxiter=3000),
           csr_ns, b)
    torch.cuda.synchronize()
    launches["strip_spmv"] = krg.LAUNCHES["strip_spmv"]
    check(launches["strip_spmv"] > 0, "the FEM path launched strip_spmv no time")

    # the kernel against its plain version at full size, f32 and f64
    e_full = compare("strip_spmv", y_st, ks.strip_spmv_ref(st, x), 1e-5, "fem strip f32")
    st64, x64 = st.astype(torch.float64), x.double()
    e_full64 = compare("strip_spmv", tsm.spmv(st64, x64), ks.strip_spmv_ref(st64, x64),
                       1e-12, "fem strip f64")
    del st64
    parts = [p.c_total for p in st.parts]
    say("10 fem path", f"fem_block_band: {n} rows, {csr.n_non_zero_entries()} entries; "
        f"generate {t_gen:.3f} s, add_batch {t_add:.3f} s, to_csr {t_csr:.3f} s, "
        f"to_strip {t_strip:.3f} s; {len(st.parts)} parts, c_total {min(parts)}–{max(parts)}, "
        f"nse {st.nse}, fill {st.fill_ratio():.3f}; spmv vs CSR rel err {e_spmv:.2e}, vs the "
        f"plan's walk {e_walk:.2e}; kernel vs plain f32 {e_full:.2e} f64 {e_full64:.2e}; "
        f"spmm m = 128 (one strip_spmm launch) vs the CSR SpMM {e_spmm:.2e}; "
        f"Gershgorin λ ∈ [1, {lam_max:.4f}]; solves to rtol {SOLVE_RTOL} "
        "(iterations, true relative residual f64): "
        + "; ".join(f"{k} {it} {r:.3e}" for k, (it, r) in report.items())
        + f"; f32 PCG at rtol 1e-12 stalls at {stall:.3e}, refine (f64 over f32 PCG) "
        f"reaches {refined:.3e} in {len(info_ref.residual_history)} outer / "
        f"{int(info_ref.iterations)} inner steps; strip launches {launches['strip_spmv']}")
    say("10 fem path", plan_line("StripELL", plan, t_plan))

    # 11 -----------------------------------------------------------------------
    check(torch.equal(tsm.spmv(st, x), y_st), "strip spmv rerun differs")
    x_pcg2, info_pcg2 = solvers.cg(st, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000, M=Mj)
    check(torch.equal(x_pcg2, x_pcg) and torch.equal(info_pcg2.residual_norm,
                                                      info_pcg.residual_norm),
          "PCG(Jacobi) rerun differs")
    say("11 determinism", "strip spmv and PCG(Jacobi) rerun bitwise equal")

    # 12 -----------------------------------------------------------------------
    k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: tsm.spmv(st, x),
                                           lambda: ks.strip_spmv_ref(st, x), 20)
    A_lib = torch_csr(csr)
    lib = library_ms(lambda: torch.mv(A_lib, x), 20)
    del A_lib
    nnz = csr.n_non_zero_entries()
    need_v, of = spmv_need(plan, csr)
    b_ms, _ = record(times, "strip_spmv", k_ms, p_ms, need_v, 2 * nnz, lib)
    times["strip_spmv"]["bound_counts"] = of
    per = note_steps(times, "strip_spmv", per_step(
        lambda: krg.LAUNCHES, lambda j: solvers.cg(st, b, tol=0.0, maxiter=j, M=Mj), 32, st)[
            "strip_spmv"], "PCG(Jacobi) iteration, FEM StripELL")
    d_ms = device_us(lambda: tsm.spmv(st, x), 20, "rowgroup_spmv_kernel",
                     lambda: krg.LAUNCHES["strip_spmv"]) / 1e3
    mp = (plan.nbytes + sum(csr.shape) * 4) / 1e6          # the plan, x and y once each
    say("12 times", f"strip spmv fem f32: kernel {k_ms:.4f} ms per call "
        f"({nnz / k_ms / 1e6:.3f} Gnnz/s) runs {k_runs}, of it {d_ms:.4f} ms on the device "
        f"(profiler): {mp / d_ms:.1f} GB/s of the plan, x and y ({mp:.1f} MB); plain "
        f"{p_ms:.4f} ms runs {p_runs}; bound {b_ms:.4f} ms (bytes of the {of}: {need_v} "
        f"against the CSR's {need_bytes(nnz, csr.shape)}); torch.mv on the CSR {lib} ms; "
        f"launches per PCG iteration {per}")
    plain = lambda v: ks.strip_spmv_ref(st, v)  # noqa: E731
    runs = [cg_iters_per_s(plain, b, 64, Mj), cg_iters_per_s(st, b, 256, Mj),
            cg_iters_per_s(st, b, 256, Mj), cg_iters_per_s(plain, b, 64, Mj)]
    say("12 times", f"PCG(Jacobi) f32 fem: kernel {(runs[1] + runs[2]) / 2:.1f} iters/s "
        f"runs {runs[1:3]}; plain {(runs[0] + runs[3]) / 2:.1f} iters/s "
        f"runs {[runs[0], runs[3]]}")


def route_cases():
    """(label, scipy matrix) for the route kernel against its plain
    version: the JAX package's RouteStream test matrices
    (tests/test_route.py), a layout with two splits, and a row of 3,500
    entries beside empty rows (it spans 3 tiles at the default 1,536
    items)."""
    def scatter(n, dens, seed, with_zero=False):
        m = sp.random(n, n, dens, random_state=seed, format="csr").astype(np.float32)
        m.data = (m.data * 10 - 5).astype(np.float32)
        m = (m + sp.eye(n, dtype=np.float32, format="csr")).tocsr()
        if with_zero:
            m.data[0] = 0.0                 # a stored entry whose value is zero
        return m

    rng = np.random.default_rng(5)
    deg = np.minimum(rng.zipf(1.7, 700), 300)  # rows of more than 128 entries
    src = np.repeat(np.arange(700), deg)
    zipf = sp.coo_matrix((rng.standard_normal(src.size).astype(np.float32),
                          (src, rng.integers(0, 700, src.size))), shape=(700, 700)).tocsr()
    zipf.sum_duplicates()
    cases = [(f"test_route n={n}", scatter(n, d, s))
             for n, d, s in ((300, 0.01, 1), (1000, 0.004, 2), (257, 0.03, 3), (64, 0.2, 4))]
    cases += [("zipf rows", zipf), ("stored zero", scatter(200, 0.02, 7, with_zero=True)),
              ("rectangular 300x250", scatter(300, 0.01, 9)[:, :250].tocsr()),
              ("empty 5x7", sp.csr_matrix((5, 7), dtype=np.float32)),
              ("3x3", sp.csr_matrix(np.array([[1.0, 0, 2.0], [0, 0, 0], [0, 3.0, 0]],
                                             np.float32))),
              ("two splits", sp.random(600, 128, 0.5, format="csr", dtype=np.float32,
                                       random_state=np.random.default_rng(0))),
              ("heavy row", heavy_route_row())]
    return cases


def heavy_route_row():
    """400×4000 scatter with row 7 holding 3,500 entries and rows 9 and
    100–119 empty (tests/test_torch_route_merge.py's ``heavy``)."""
    m = sp.random(400, 4000, 0.002, format="lil", dtype=np.float32, random_state=3)
    m[7, :3500] = 1.5
    m[9, :] = 0
    m[100:120, :] = 0
    return m.tocsr()


def check_route_kernel(rs, x, tol, what, tiles=(8, 16)):
    """The route kernel through ``spmv`` (the plan's own split) and over
    splits of ``tiles`` items against its plain version (the table halves)
    and bitwise against the walk of the same split; reruns bitwise.  The
    worst relative error."""
    y, y_ref = tsm.spmv(rs, x), kr.route_spmv_ref(rs, x)
    check(y.dtype == y_ref.dtype, f"{what}: dtype {y.dtype} vs {y_ref.dtype}")
    check(torch.equal(tsm.spmv(rs, x), y), f"route_spmv {what}: rerun differs")
    plan = krg.plan_of(rs)
    errs = []
    for split in [plan.merge] + [krg.MergeSplit(plan, t) for t in tiles]:
        got = y if split is plan.merge else kr.launch(plan, split, x)
        walk = kr.route_spmv_walk(plan, split, x)
        where = f"route_spmv {what} tile {split.items}"
        errs.append(compare("route_spmv", got, y_ref, tol, where))
        check(torch.equal(got, walk), f"{where}: differs from the walk of its split by "
              f"{float((got.double() - walk.double()).abs().max()):.3e}")
    return max(errs)


def circuit_symmetric(m):
    """The symmetric variant of the circuit operator: off-diagonals
    (O + Oᵀ)/2 and diagonal Σ_j≠i |a_ij| + 1 (strictly dominant, SPD)."""
    off = (m - sp.diags(m.diagonal())).tocsr()
    off = ((off + off.T) * 0.5).tocsr()
    off.eliminate_zeros()
    d = np.asarray(abs(off).sum(axis=1)).ravel() + 1.0
    return (off + sp.diags(d.astype(np.float32))).tocsr().astype(np.float32)


def bicgstab_iters_per_s(A, b, iters):
    solvers.bicgstab(A, b, tol=0.0, maxiter=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = solvers.bicgstab(A, b, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(int(info.iterations) == iters, "BiCGStab stopped early")
    return iters / dt


def route_phases(dev, g, times, launches):
    """Phases 13–16: the route kernel against its plain version and its
    walk, and the circuit path.  Adds the route kernel's times and main-path
    launches to ``times`` and ``launches``."""
    # 13 -----------------------------------------------------------------------
    worst = {}
    for label, m in route_cases():
        m = m.tocsr()
        m.sort_indices()
        rs = tsm.CSR.from_scipy(m, device=dev).to_route()
        check(rs.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        plan = krg.plan_of(rs)
        check(plan.group == 1 and np.array_equal(plan.grp_ptr.cpu().numpy(), m.indptr)
              and np.array_equal(plan.cols.cpu().numpy(), m.indices)
              and np.array_equal(plan.vals[0].cpu().numpy(), m.data),
              f"{label}: the RouteStream's plan is not its CSR")
        xs = torch.randn(m.shape[1], generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            x_dt = xs.to(torch.float32 if dt == torch.bfloat16 else dt)
            errs.append(check_route_kernel(rs.astype(dt), x_dt, TOL[dt]["y"], f"{label} {dt}"))
        split = plan.merge
        worst[f"{label} ({split.n_tiles} tiles, {split.n_span} spanning rows, longest "
              f"{split.longest})"] = max(errs)
    torch.cuda.synchronize()
    say("13 route", "kernel vs plain within tolerance and bitwise equal to the walk at tiles "
        f"of {krg.MERGE_ITEMS}, 8 and 16 items (f32, f64, bf16 values); worst rel err per "
        "case: " + "; ".join(f"{w} {e:.2e}" for w, e in worst.items()))

    # 14 -----------------------------------------------------------------------
    host = {}
    t0 = time.perf_counter()
    m = (matgen.circuit_scatter(seed=SEED) * 2e-2).tocsr()
    m.sort_indices()
    host["generate"] = time.perf_counter() - t0
    check(m.dtype == np.float32, f"the circuit operator is {m.dtype}")
    n = m.shape[0]
    with tempfile.TemporaryDirectory() as td:
        mtx, npz = os.path.join(td, "circuit.mtx"), os.path.join(td, "circuit_route.npz")
        t0 = time.perf_counter()
        tio.save_mtx(tsm.CSR.from_scipy(m), mtx)
        host["save_mtx"] = time.perf_counter() - t0
        mtx_mb = os.path.getsize(mtx) / 1e6
        krg.reset_launches()
        t0 = time.perf_counter()
        csr = tio.load_mtx(mtx, device=dev)
        torch.cuda.synchronize()
        host["load_mtx"] = time.perf_counter() - t0
        check(tio.last_mtx_parser == "native", f"load_mtx took the {tio.last_mtx_parser} parser")
        check(np.array_equal(csr.host("indptr"), m.indptr)
              and np.array_equal(csr.host("indices"), m.indices)
              and np.array_equal(csr.host("data"), m.data), "load_mtx changed the matrix")
        t0 = time.perf_counter()
        rs0 = csr.to_route()
        torch.cuda.synchronize()
        host["to_route"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save_matrix(npz, rs0)
        host["save_matrix"] = time.perf_counter() - t0
        npz_mb = os.path.getsize(npz) / 1e6
        t0 = time.perf_counter()
        rs = checkpoint.load_matrix(npz, device=dev)
        torch.cuda.synchronize()
        host["load_matrix"] = time.perf_counter() - t0
    check(isinstance(rs, tsm.RouteStream) and rs.a_vals.device == csr.data.device,
          "load_matrix did not give a RouteStream on the card")
    x = torch.randn(n, generator=g, device=dev)
    y = tsm.spmv(rs, x)
    check(torch.equal(tsm.spmv(rs0, x), y), "the reloaded RouteStream's spmv differs")
    e_csr = compare(None, y, tsm.spmv(csr, x), 1e-5, "circuit spmv route kernel vs CSR stream")
    b = torch.randn(n, generator=g, device=dev)
    report = {}

    def solved(label, x_, info, A_csr, b_):
        rel = true_rel(A_csr, x_, b_)
        check(bool(info.converged), f"{label} did not converge in {int(info.iterations)}")
        check(rel <= SOLVE_TRUE_REL, f"{label}: true relative residual {rel:.3e} > {SOLVE_TRUE_REL}")
        report[label] = (int(info.iterations), rel)

    x_bi, info_bi = solvers.bicgstab(rs, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    solved("BiCGStab", x_bi, info_bi, csr, b)
    solved("GMRES(30)", *solvers.gmres(rs, b, tol=0.0, rtol=SOLVE_RTOL, restart=30,
                                       maxiter=3000), csr, b)
    solved("Jacobi", *solvers.jacobi(rs, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=5000), csr, b)
    msym = circuit_symmetric(m)
    csr_sym = tsm.CSR.from_scipy(msym, device=dev)
    rs_sym = csr_sym.to_route()
    check(float((tsm.spmv(rs_sym, x) - y).abs().max()) > 0.01, "the symmetric variant is A")
    solved("PCG(Jacobi) symmetric",
           *solvers.cg(rs_sym, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000,
                       M=solvers.JacobiPreconditioner.from_matrix(csr_sym)), csr_sym, b)
    B16 = torch.randn(m.shape[1], 16, generator=g, device=dev)
    e_spmm = compare(None, tsm.spmm(rs, B16), tsm.spmm(csr, B16), 1e-5,
                     "circuit spmm route_spmm kernel vs the CSR SpMM, m = 16")
    del B16
    torch.cuda.synchronize()
    for name in ROUTE_KEYS:
        launches[name] = krg.LAUNCHES[name]
        check(launches[name] > 0, f"the circuit path launched {name} no time")

    full = []
    for dt in (torch.float32, torch.float64):
        full.append(check_route_kernel(rs.astype(dt), x.to(dt), TOL[dt]["y"],
                                       f"circuit {dt}", tiles=(256,)))
    say("14 circuit", f"circuit_scatter·2e-2: {n} rows, {csr.n_non_zero_entries()} entries, "
        f"longest row {int(np.diff(m.indptr).max())}; .mtx {mtx_mb:.1f} MB, checkpoint "
        f"{npz_mb:.1f} MB; n_sup {rs.n_sup}, n_splits {rs.n_splits}, n_regions "
        f"{rs.n_regions}, nse {rs.nse}, fill {rs.fill_ratio():.3f}, spmv_traffic_bytes "
        f"{rs.spmv_traffic_bytes()}; spmv vs CSR rel err {e_csr:.2e}; spmm m = 16 (route_spmm) "
        f"vs the CSR SpMM {e_spmm:.2e}; kernels vs plain "
        f"f32 {full[0]:.2e} f64 {full[1]:.2e} (and bitwise equal to the walk); solves to rtol {SOLVE_RTOL} (iterations, true "
        "relative residual f64): "
        + "; ".join(f"{k} {it} {r:.3e}" for k, (it, r) in report.items())
        + f"; route launches {({k: launches[k] for k in ROUTE_KEYS})}")

    # 15 -----------------------------------------------------------------------
    check(torch.equal(tsm.spmv(rs, x), y), "route spmv rerun differs")
    x_bi2, info_bi2 = solvers.bicgstab(rs, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    check(torch.equal(x_bi2, x_bi) and torch.equal(info_bi2.residual_norm,
                                                   info_bi.residual_norm),
          "BiCGStab rerun differs")
    say("15 determinism", "route spmv and BiCGStab rerun bitwise equal")

    # 16 -----------------------------------------------------------------------
    nnz = csr.n_non_zero_entries()
    plan = krg.plan_of(rs)
    split = plan.merge
    need = need_bytes(nnz, csr.shape)
    mb = (plan.nbytes + 2 * n * 4) / 1e6        # what the kernel reads and writes
    k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: tsm.spmv(rs, x),
                                           lambda: kr.route_spmv_ref(rs, x), 20)
    d_ms = device_us(lambda: tsm.spmv(rs, x), 20, "route_spmv_kernel",
                     lambda: krg.LAUNCHES["route_spmv"]) / 1e3
    A_lib = torch_csr(csr)
    lib = library_ms(lambda: torch.mv(A_lib, x), 20)
    del A_lib
    b_ms, _ = record(times, "route_spmv", k_ms, p_ms, need, 2 * nnz, lib)
    times["route_spmv"].update(device_ms=d_ms, bound_counts="CSR")
    # the row-group SpMV over the same G = 1 plan, for the choice of kernel
    # on such plans (launched here only)
    rg_count = {"rowgroup_spmv": 0}
    y_rg = krg.launch_spmv(plan, x, rg_count, "rowgroup_spmv")
    e_rg = compare(None, y_rg, y, 1e-5, "row-group SpMV over the route plan vs the route kernel")
    rg_ms = cuda_ms(lambda: krg.launch_spmv(plan, x, rg_count, "rowgroup_spmv"), 20)
    rg_d_ms = device_us(lambda: krg.launch_spmv(plan, x, rg_count, "rowgroup_spmv"), 20,
                        "rowgroup_spmv_kernel", lambda: rg_count["rowgroup_spmv"]) / 1e3
    times["route_spmv"].update(rowgroup_ms=rg_ms, rowgroup_device_ms=rg_d_ms)
    say("16 times", f"route spmv circuit f32: kernel {k_ms:.4f} ms per call runs {k_runs}, of "
        f"it {d_ms:.4f} ms on the device (profiler; {mb / d_ms:.1f} GB/s of the {mb:.2f} MB "
        f"plan, x and y; {nnz / d_ms / 1e6:.3f} Gnnz/s); plain {p_ms:.4f} ms runs {p_runs}; "
        f"bound {b_ms:.4f} ms ({need} bytes of the CSR, x and y); torch.mv on the CSR {lib} "
        f"ms; the row-group SpMV over the same G = 1 plan {rg_ms:.4f} ms per call, "
        f"{rg_d_ms:.4f} ms on the device ({plan.spmv.lanes} lanes, {plan.spmv.n_seg} "
        f"segments; rel err to the route kernel {e_rg:.2e})")
    say("16 times", f"merge split: {split.items} items a tile ({split.ipt} a thread), "
        f"{split.n_tiles} tiles for {n} rows and {nnz} entries, {split.n_span} spanning rows "
        f"({split.n_partial} partials), the longest over {split.longest} tiles")
    sweep = {}
    for items in (256, 512, 1024, 1536, 2048):
        sp_ = krg.MergeSplit(plan, items)
        check(torch.equal(kr.launch(plan, sp_, x), kr.route_spmv_walk(plan, sp_, x)),
              f"route_spmv at {items} items differs from its walk")
        sweep[items] = device_us(lambda: kr.launch(plan, sp_, x), 20, "route_spmv_kernel",
                                 lambda: krg.LAUNCHES["route_spmv"]) / 1e3
    say("16 times", "route kernel device ms by tile items (profiler): "
        + "; ".join(f"{k} {v:.4f} ({-(-(n + nnz) // k)} tiles)" for k, v in sweep.items()))
    per = per_step(lambda: krg.LAUNCHES,
                   lambda j: solvers.bicgstab(rs, b, tol=0.0, maxiter=j), 32, rs)
    note_steps(times, "route_spmv", per["route_spmv"], "BiCGStab iteration, circuit RouteStream")
    say("16 times", "route launches per BiCGStab iteration "
        f"{({k: per[k] for k in ROUTE_KEYS})}")
    plain = lambda v: kr.route_spmv_ref(rs, v)  # noqa: E731
    runs = [bicgstab_iters_per_s(plain, b, 32), bicgstab_iters_per_s(rs, b, 128),
            bicgstab_iters_per_s(rs, b, 128), bicgstab_iters_per_s(plain, b, 32)]
    say("16 times", f"BiCGStab f32 circuit: kernel {(runs[1] + runs[2]) / 2:.1f} iters/s "
        f"runs {runs[1:3]}; plain {(runs[0] + runs[3]) / 2:.1f} iters/s "
        f"runs {[runs[0], runs[3]]}")
    say("16 times", "host seconds: " + "; ".join(f"{k} {v:.3f}" for k, v in host.items()))


def blocky(n_rows, n_cols, density, seed, block=(8, 128)):
    """The JAX package's BSR test matrices (tests/test_bsr_spmm.py): whole
    (br × bc) blocks switched on at ``density``."""
    rng = np.random.default_rng(seed)
    br, bc = block
    mask = rng.random((-(-n_rows // br), -(-n_cols // bc))) < density
    dense = np.zeros((mask.shape[0] * br, mask.shape[1] * bc), np.float32)
    for i, j in zip(*np.nonzero(mask)):
        dense[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = rng.standard_normal((br, bc))
    return sp.csr_matrix(dense[:n_rows, :n_cols])


def sprinkled(n_rows, n_cols, density, seed, empty_rows=None, zeros=()):
    """Random entries at ``density``; rows ``empty_rows`` (a slice) cleared
    and the stored entries at ``zeros`` set to the value zero."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    dense[rng.random((n_rows, n_cols)) >= density] = 0
    if empty_rows is not None:
        dense[empty_rows] = 0
    m = sp.csr_matrix(dense)
    m.data[list(zeros)] = 0.0
    return m


def bsr_cases():
    """(label, scipy matrix, (br, bc), m) for the BSR kernel against its
    plain version: tests/test_bsr_spmm.py's shapes, empty block rows, the
    block shapes 8/16/512 × 128/256, m = 0 and nnz = 0."""
    holes = sprinkled(300, 520, 0.03, 11, empty_rows=slice(40, 120))
    return [("64x256 m=64", blocky(64, 256, 0.15, 4), (8, 128), 64),
            ("100x300 m=129", blocky(100, 300, 0.15, 4), (8, 128), 129),
            ("empty block rows 8x128", holes, (8, 128), 17),
            ("empty block rows 16x256", holes, (16, 256), 17),
            ("empty block rows 512x128", holes, (512, 128), 130),
            ("stored zero 64x128 m=1", sprinkled(72, 150, 0.1, 2, zeros=(0, 5)), (64, 128), 1),
            ("m=0", blocky(64, 256, 0.15, 4), (8, 128), 0),
            ("nnz=0", sp.csr_matrix((64, 64), dtype=np.float32), (8, 128), 8)]


def scattered_band(n, k, band, seed):
    """The JAX package's SlabELL test matrices (tests/test_slab.py)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k), 0, n - 1)
    m = sp.csr_matrix((rng.standard_normal(n * k).astype(np.float32), (rows, cols)),
                      shape=(n, n))
    m.sum_duplicates()
    return m


def mixed_degree(n, seed):
    """Interleaved light and heavy rows (tests/test_gell_pack.py): the
    SlabPack spills, so it has an overflow pack."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), np.where(np.arange(n) % 7, 3, 60))
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def slab_cases():
    """(label, scipy matrix, freeze) for the slab kernels against their
    plain versions: SlabELL at rb 128 and 256, SlabPack with and without
    spill, a rectangular matrix, an empty one and a stored zero."""
    zero = scattered_band(300, 9, 50, 8)
    zero.data[[0, 11]] = 0.0
    fem = (sp.random(700, 700, 0.02, random_state=3, format="csr").astype(np.float32)
           + sp.eye(700, dtype=np.float32, format="csr")).tocsr()
    rect = sp.random(300, 900, 0.02, format="csr", dtype=np.float32,
                     random_state=np.random.default_rng(4))
    mixed = mixed_degree(2000, 0)
    slab = lambda rb: (lambda c: c.to_slab(rb=rb))  # noqa: E731
    pack = lambda **kw: (lambda c: tsm.SlabPack.from_csr(c, **kw))  # noqa: E731
    return [("slab 400 rb=128", scattered_band(400, 9, 50, 3), slab(128)),
            ("slab 260 k=140 rb=256", scattered_band(260, 140, 20, 3), slab(256)),
            ("slab 300 band 200 rb=128", scattered_band(300, 5, 200, 3), slab(128)),
            ("slab rectangular 300x900", rect, slab(256)),
            ("slab stored zero", zero, slab(128)),
            ("slab empty", sp.csr_matrix((300, 200), dtype=np.float32), slab(256)),
            ("pack spill 0.02", mixed, pack(n_classes=6, spill_frac=0.02)),
            ("pack no spill", mixed, pack(n_classes=6, spill_frac=0.0)),
            ("pack fem 700 rb=128", fem, pack(rb=128, n_classes=3)),
            ("pack rectangular 300x900", rect, pack()),
            ("pack empty", sp.csr_matrix((300, 200), dtype=np.float32), pack())]


def slab_ops(mat):
    """(spmv, spmv plain, spmm, spmm plain) of a SlabELL or SlabPack."""
    if isinstance(mat, tsm.SlabPack):
        return (tsm.spmv, ksl.slab_pack_spmv_ref, tsm.spmm,
                ksl.slab_pack_spmm_ref)
    return tsm.spmv, ksl.slab_spmv_ref, tsm.spmm, ksl.slab_spmm_ref


def check_non_finite_b(dev):
    """Where B holds inf or NaN, the row-group kernel gives scipy's CSR
    SpMM answer: a stored zero meets inf (0 · inf = NaN in both), and a
    column that only a BSR block's unstored zeros and a SlabELL's padding
    slots point at holds NaN (no NaN from it, where the dense plain
    versions give one)."""
    m = sprinkled(300, 520, 0.03, 11, zeros=(0,)).tocoo()
    keep = m.col != 128                     # inside stored blocks, under padding slots
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])
    B = np.ones((520, 2), np.float32)
    B[int(m.indices[z]), 0] = np.inf
    B[128, 1] = np.nan
    want = m @ B
    check(np.isnan(want).sum() == 1, "the non-finite case: scipy gives one NaN")
    csr = tsm.CSR.from_scipy(m, device=dev)
    Bt = torch.from_numpy(B).to(dev)
    out = {}
    for label, mat, fn, ref in (("bsr", tsm.BSR.from_csr(csr), tsm.spmm, ksp.bsr_spmm_ref),
                                ("slab", csr.to_slab(rb=128), tsm.spmm, ksl.slab_spmm_ref)):
        got = fn(mat, Bt).cpu().numpy()
        inf = np.isinf(want)
        check(np.array_equal(np.isnan(got), np.isnan(want))
              and np.array_equal(got[inf], want[inf]),
              f"non-finite B through {label}: NaN or inf where scipy has none, or the reverse")
        ok = np.isfinite(want)
        compare(None, torch.from_numpy(got[ok]), torch.from_numpy(want[ok]), 1e-5,
                f"non-finite B through {label}, finite entries")
        out[label] = (f"{int(np.isnan(got).sum())} NaN as scipy, plain version "
                      f"{int(torch.isnan(ref(mat, Bt)).sum())}")
    return out


def plan_line(label, plan, seconds):
    """The row-group plan of one matrix and its SpMV split, for the phase
    lines."""
    split = plan.spmv
    return (f"{label} plan: built in {seconds:.3f} s, {plan.nbytes / 1e6:.1f} MB, groups of "
            f"{plan.group}, {plan.n_union} union columns for {plan.nnz} entries, padding "
            f"{plan.padding:.4f}; SpMV: {split.lanes} lanes, {split.n_seg} segments of at most "
            f"{split.seg_cols} union columns, {split.n_multi} groups of several segments")


def spmv_need(plan, csr):
    """(bytes, "plan" or "CSR"): what an SpMV over the row-group plan needs,
    the smaller of the CSR's count (``need_bytes``) and the plan's bytes,
    x and y once each (a plan that shares each column among G rows holds
    fewer bytes than the CSR)."""
    n_rows, n_cols = csr.shape
    of_csr = need_bytes(csr.n_non_zero_entries(), csr.shape)
    of_plan = plan.nbytes + (n_rows + n_cols) * 4
    return (of_plan, "plan") if of_plan < of_csr else (of_csr, "CSR")


def narrow_spmm_times(csr, B, nnz, widths=(1, 8, 32, 128)):
    """The row-group SpMM over the FEM operator's StripELL plan at each
    width (f32): kernel ms a call (CUDA events, in turns with the plan's
    walk, its plain version), device ms (profiler), the bound of
    ``portbench/roofline.py`` (values, B and Y once; ``product_bound_s``)
    and ``torch.sparse.mm`` on the CSR; checks that every launch counted
    under its ``spmm_lanes`` width.  Returns one line per width."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench"))
    import roofline

    st = csr.to_strip()
    plan = krg.plan_of(st)
    A_lib = torch_csr(csr)
    n_rows, n_cols = csr.shape
    lines = []
    for m_w in widths:
        B_w = B[:, :m_w].contiguous()
        lanes = str(krg.spmm_lanes(m_w, B_w.element_size()))
        compare(None, tsm.spmm(st, B_w), krg.walk(plan, B_w), 1e-5,
                f"fem strip spmm m={m_w} vs its plan's walk")
        before, calls = dict(krg.LANE_LAUNCHES), krg.LAUNCHES["strip_spmm"]
        k_ms, p_ms, k_runs, _ = paired_ms(lambda: tsm.spmm(st, B_w), lambda: krg.walk(plan, B_w),
                                          20, 2)
        d_ms = device_us(lambda: tsm.spmm(st, B_w), 20, "rowgroup_spmm_kernel",
                         lambda: krg.LAUNCHES["strip_spmm"]) / 1e3
        rose = {k: krg.LANE_LAUNCHES[k] - before[k] for k in before}
        made = krg.LAUNCHES["strip_spmm"] - calls
        check(made > 0 and rose == dict.fromkeys(rose, 0) | {lanes: made},
              f"fem strip spmm m={m_w}: launches by lane width {rose}, {made} launches, "
              f"all at {lanes} expected")
        bound_s, by = roofline.product_bound_s(nnz, n_rows, n_cols, m_w)
        lib_ms = library_ms(lambda: torch.sparse.mm(A_lib, B_w), 20)
        lines.append(f"m={m_w} ({lanes} lanes a group) kernel {k_ms:.4f} runs {k_runs}, device "
                     f"{d_ms:.4f} ({100 * bound_s * 1e3 / d_ms:.1f}% of the {bound_s * 1e3:.4f} "
                     f"ms {by} bound), plain {p_ms:.4f}, torch.sparse.mm {lib_ms:.4f}")
    return lines


def spmm_phases(dev, g, times, launches):
    """Phases 17–20: the BSR and slab kernels against their plain versions,
    and the FEM SpMM path at full size.  Adds the three kernels' times and
    main-path launches to ``times`` and ``launches``."""
    # 17 -----------------------------------------------------------------------
    worst = {}
    for label, m, (br, bc), m_rhs in bsr_cases():
        bsr = tsm.BSR.from_csr(tsm.CSR.from_scipy(m, device=dev), br=br, bc=bc)
        check(bsr.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        Bs = torch.randn(m.shape[1], m_rhs, generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            b_dt = bsr.astype(dt)
            B_dt = Bs.to(torch.float32 if dt == torch.bfloat16 else dt)
            Y, Y_ref = tsm.spmm(b_dt, B_dt), ksp.bsr_spmm_ref(b_dt, B_dt)
            check(Y.dtype == Y_ref.dtype, f"{label}: dtype {Y.dtype} vs {Y_ref.dtype}")
            errs.append(compare("bsr_spmm", Y, Y_ref, TOL[dt]["y"], f"bsr {label} {dt}"))
        worst[label] = max(errs)
    holes = sprinkled(300, 520, 0.03, 11, empty_rows=slice(40, 120))
    csr_h = tsm.CSR.from_scipy(holes, device=dev)
    Bh = torch.randn(520, 33, generator=g, device=dev)
    for br in (8, 64, 256):
        host, devf = tsm.BSR.from_csr(csr_h, br=br), tsm.BSR.from_csr_device(csr_h, br=br)
        check(torch.equal(host.blocks, devf.blocks)
              and torch.equal(host.block_rows, devf.block_rows)
              and torch.equal(host.block_cols, devf.block_cols) and devf.occ is None,
              f"from_csr_device br={br} differs from the host freeze")
        check(torch.equal(tsm.spmm(host, Bh), tsm.spmm(devf, Bh)),
              f"bsr_spmm of the device freeze br={br} differs")
    torch.cuda.synchronize()
    say("17 bsr", "kernel vs plain within tolerance (f32, f64, bf16 blocks); from_csr_device "
        "equals the host freeze (br 8, 64, 256); worst rel err per case: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items()))

    # 18 -----------------------------------------------------------------------
    worst = {}
    for label, m, freeze in slab_cases():
        mat = freeze(tsm.CSR.from_scipy(m, device=dev))
        check(mat.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        xs = torch.randn(m.shape[1], generator=g, device=dev)
        Bs = torch.randn(m.shape[1], 129, generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            m_dt = mat.astype(dt)
            a_dt = torch.float32 if dt == torch.bfloat16 else dt
            spmv, spmv_ref, spmm, spmm_ref = slab_ops(m_dt)
            y, y_ref = spmv(m_dt, xs.to(a_dt)), spmv_ref(m_dt, xs.to(a_dt))
            check(y.dtype == y_ref.dtype, f"{label}: dtype {y.dtype} vs {y_ref.dtype}")
            errs.append(compare("slab_spmv", y, y_ref, TOL[dt]["y"], f"{label} spmv {dt}"))
            for m_rhs in (1, 5, 17, 128, 129):
                B = Bs[:, :m_rhs].to(a_dt)
                errs.append(compare("slab_spmm", spmm(m_dt, B), spmm_ref(m_dt, B),
                                    TOL[dt]["y"], f"{label} spmm m={m_rhs} {dt}"))
        over = getattr(mat, "overflow", None)
        worst[label + (" (overflow)" if over is not None else "")] = max(errs)
    nonfinite = check_non_finite_b(dev)
    torch.cuda.synchronize()
    say("18 slab", "spmv and spmm kernels vs plain within tolerance (f32, f64, bf16 values; "
        "m = 1, 5, 17, 128, 129); worst rel err per case: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items())
        + f"; non-finite B: {nonfinite}")

    # 19 -----------------------------------------------------------------------
    host = {}
    fem = (matgen.fem_block_band(seed=SEED) * np.float32(2e-2)).astype(np.float32).tocsr()
    fem.sort_indices()
    n, nnz, m_rhs = fem.shape[0], fem.nnz, 128
    rng = np.random.default_rng(3)
    B_host = (rng.standard_normal((n, m_rhs)) * 0.01).astype(np.float32)
    ref_y = fem[:256] @ B_host[:, :8]
    csr = tsm.CSR.from_scipy(fem, device=dev)
    B = torch.from_numpy(B_host).to(dev)
    x = torch.randn(n, generator=g, device=dev)
    torch.cuda.synchronize()
    krg.reset_launches()
    t0 = time.perf_counter()
    bsr = tsm.BSR.from_csr_device(csr, br=512, bc=128)
    torch.cuda.synchronize()
    host["from_csr_device"] = time.perf_counter() - t0
    plans = {}

    def timed_plan(label, mat):
        """Build the matrix's row-group plan and its SpMV split (which its
        first product would build) and time them."""
        t0 = time.perf_counter()
        plans[label] = krg.plan_of(mat)
        plans[label].spmv
        torch.cuda.synchronize()
        host[f"{label} plan"] = time.perf_counter() - t0

    timed_plan("BSR", bsr)
    Y_bsr = tsm.spmm(bsr, B)
    t0 = time.perf_counter()
    pk = csr.to_slab_pack()
    torch.cuda.synchronize()
    host["to_slab_pack"] = time.perf_counter() - t0
    timed_plan("SlabPack", pk)
    y_pk = tsm.spmv(pk, x)
    Y_pk = tsm.spmm(pk, B)
    t0 = time.perf_counter()
    sl = csr.to_slab()
    torch.cuda.synchronize()
    host["to_slab"] = time.perf_counter() - t0
    timed_plan("SlabELL", sl)
    y_sl = tsm.spmv(sl, x)
    Y_sl = tsm.spmm(sl, B)
    for label, mat in (("SlabPack", pk), ("SlabELL", sl)):
        check(krg.plan_of(mat) is plans[label]
              and [k for k in mat.__dict__ if k.endswith("plan")] == ["_rowgroup_plan"],
              f"the {label}'s spmv and spmm did not share its one plan")
    with tempfile.TemporaryDirectory() as td:
        npz = os.path.join(td, "fem_slab_pack.npz")
        t0 = time.perf_counter()
        checkpoint.save_matrix(npz, pk)
        host["save_matrix"] = time.perf_counter() - t0
        npz_mb = os.path.getsize(npz) / 1e6
        t0 = time.perf_counter()
        pk2 = checkpoint.load_matrix(npz, device=dev)
        torch.cuda.synchronize()
        host["load_matrix"] = time.perf_counter() - t0
    check(isinstance(pk2, tsm.SlabPack) and pk2.block_ids == pk.block_ids,
          "load_matrix did not give the SlabPack back")
    check(torch.equal(tsm.spmv(pk2, x), y_pk), "the reloaded SlabPack's spmv differs")
    torch.cuda.synchronize()
    for name in ("bsr_spmm", "slab_spmv", "slab_spmm"):
        launches[name] = krg.LAUNCHES[name]
        check(launches[name] > 0, f"the FEM SpMM path launched {name} no time")

    spot = compare(None, Y_bsr[:256, :8].cpu(), torch.from_numpy(ref_y), 1e-3,
                   "fem spmm BSR Y[:256, :8] vs scipy")
    Y_stream = tsm.spmm(csr, B)              # the CSR branch: ELL or column-tiled stream
    y_csr = tsm.spmv(csr, x)
    y_strip = tsm.spmv(csr.to_strip(), x)
    errs = {"BSR kernel vs plain": compare("bsr_spmm", Y_bsr, ksp.bsr_spmm_ref(bsr, B), 1e-5,
                                           "fem bsr kernel vs plain"),
            "BSR kernel vs plan walk": compare(None, Y_bsr, krg.walk(plans["BSR"], B), 1e-5,
                                               "fem bsr kernel vs its plan's walk"),
            "pack kernel vs plan walk": compare(None, Y_pk, krg.walk(plans["SlabPack"], B),
                                                1e-5, "fem pack kernel vs its plan's walk"),
            "BSR vs CSR spmm": compare(None, Y_bsr, Y_stream, 1e-5, "fem spmm BSR vs CSR"),
            "pack spmv kernel vs plain": compare("slab_spmv", y_pk,
                                                 ksl.slab_pack_spmv_ref(pk, x), 1e-5,
                                                 "fem pack spmv kernel vs plain"),
            "pack spmv kernel vs plan walk": compare(None, y_pk,
                                                     krg.spmv_walk(plans["SlabPack"], x), 1e-5,
                                                     "fem pack spmv kernel vs its plan's walk"),
            "pack spmv vs strip": compare(None, y_pk, y_strip, 1e-5, "fem pack vs strip spmv"),
            "pack spmv vs CSR": compare(None, y_pk, y_csr, 1e-5, "fem pack vs CSR spmv"),
            "pack spmm kernel vs plain": compare("slab_spmm", Y_pk,
                                                 ksl.slab_pack_spmm_ref(pk, B), 1e-5,
                                                 "fem pack spmm kernel vs plain"),
            "pack spmm vs BSR": compare(None, Y_pk, Y_bsr, 1e-5, "fem pack vs BSR spmm"),
            "pack spmm vs CSR": compare(None, Y_pk, Y_stream, 1e-5, "fem pack vs CSR spmm"),
            "slab spmv kernel vs plain": compare("slab_spmv", y_sl, ksl.slab_spmv_ref(sl, x),
                                                 1e-5, "fem slab spmv kernel vs plain"),
            "slab spmv vs CSR": compare(None, y_sl, y_csr, 1e-5, "fem slab vs CSR spmv"),
            "slab spmm kernel vs plain": compare("slab_spmm", Y_sl, ksl.slab_spmm_ref(sl, B),
                                                 1e-5, "fem slab spmm kernel vs plain"),
            "slab spmm vs BSR": compare(None, Y_sl, Y_bsr, 1e-5, "fem slab vs BSR spmm")}
    check(torch.equal(tsm.spmm(bsr, B), Y_bsr), "BSR spmm rerun differs")
    check(torch.equal(tsm.spmv(pk, x), y_pk), "SlabPack spmv rerun differs")
    check(torch.equal(y_sl, y_pk), "SlabELL and SlabPack spmv differ (one plan, one order)")
    check(torch.equal(tsm.spmm(pk, B), Y_pk), "SlabPack spmm rerun differs")
    check(torch.equal(tsm.spmm(sl, B), Y_sl), "SlabELL spmm rerun differs")
    for label, plan in plans.items():
        check(plan.nnz == nnz, f"the {label} plan holds {plan.nnz} of {nnz} entries")
    parts = [p.c_total for p in pk.parts]
    say("19 fem spmm", f"fem_block_band·2e-2: {n} rows, {nnz} entries, longest row "
        f"{int(np.diff(fem.indptr).max())}; BSR 512x128: {bsr.n_tiles} tiles, "
        f"{bsr.blocks.numel() * 4 / 1e9:.3f} GB, fill {bsr.fill_ratio():.4f}; SlabPack: "
        f"{len(pk.parts)} parts, c_total {min(parts)}–{max(parts)}, overflow "
        f"{len(pk.overflow.parts) if pk.overflow is not None else 0} parts at rb "
        f"{pk.overflow.row_block if pk.overflow is not None else '-'}, nse {pk.nse}, "
        f"spmv_traffic_bytes {pk.spmv_traffic_bytes()}; SlabELL: c_total {sl.c_total}, "
        f"{sl.slab_windows} windows, nse {sl.nse}; checkpoint {npz_mb:.1f} MB; Y[:256, :8] "
        f"vs scipy {spot:.2e}; rel errs: " + "; ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + "; reruns bitwise equal; SlabPack and SlabELL spmv bitwise equal; launches "
        + f"{({k: launches[k] for k in ('bsr_spmm', 'slab_spmv', 'slab_spmm')})}")
    for label, plan in plans.items():
        say("19 fem spmm", plan_line(label, plan, host[f"{label} plan"]))
    say("19 fem spmm", "StripELL spmm by width, ms per call: "
        + "; ".join(narrow_spmm_times(csr, B, nnz)))

    # 20 -----------------------------------------------------------------------
    del Y_stream, Y_sl
    useful = 2 * nnz * m_rhs
    A_lib = torch_csr(csr)
    lib_mm = library_ms(lambda: torch.sparse.mm(A_lib, B), 20)
    need_mm = need_bytes(nnz, csr.shape, m_rhs)

    def spmm_times(row, name, label, mat, kernel_fn, plain_fn, plain_iters):
        """Time one format's SpMM at m = 128 into ``row[name]`` (kernel,
        plain, bound, library, launches per product) and print it."""
        k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: kernel_fn(mat, B),
                                               lambda: plain_fn(mat, B), 20, plain_iters)
        b_ms, _ = record(row, name, k_ms, p_ms, need_mm, useful, lib_mm)
        per = note_steps(row, name, per_step(
            lambda: krg.LAUNCHES, lambda j: [tsm.spmm(mat, B) for _ in range(j)], 1)[name],
            f"spmm({label}, B) product")
        d_ms = device_us(lambda: kernel_fn(mat, B), 20, "rowgroup_spmm_kernel",
                         lambda: krg.LAUNCHES[name]) / 1e3
        moved = plans[label].nbytes + 2 * n * m_rhs * 4        # the plan, B and Y once each
        say("20 times", f"{label} spmm fem m=128 f32 ({name}): kernel {k_ms:.4f} ms per call "
            f"runs {k_runs}, of it {d_ms:.4f} ms on the device (profiler): "
            f"{useful / d_ms / 1e9:.4f} Tflop/s of 2·nnz·m, {moved / 1e6 / d_ms:.1f} GB/s of "
            f"the plan, B and Y ({moved} bytes); plain {p_ms:.4f} ms runs {p_runs}; bound "
            f"{b_ms:.4f} ms; torch.sparse.mm on the CSR {lib_mm} ms; launches per product {per}")

    spmm_times(times, "bsr_spmm", "BSR", bsr, tsm.spmm, ksp.bsr_spmm_ref, 5)
    del bsr, Y_bsr
    spmm_times(times, "slab_spmm", "SlabPack", pk, tsm.spmm, ksl.slab_pack_spmm_ref, 2)
    slab_ell = {}                  # the SlabELL row: the same kernel, so not a JSON kernel row
    spmm_times(slab_ell, "slab_spmm", "SlabELL", sl, tsm.spmm, ksl.slab_spmm_ref, 2)
    say("20 times", "SlabELL spmm row " + json.dumps(slab_ell["slab_spmm"]))
    widths = []
    for m_w, dt in ((1, torch.float32), (17, torch.float32), (129, torch.float32),
                    (128, torch.float64)):
        B_w = B[:, :1].repeat(1, m_w).to(dt)
        A_w = A_lib if dt == torch.float32 else torch_csr(csr.astype(dt))
        compare("slab_spmm", tsm.spmm(pk, B_w), krg.walk(plans["SlabPack"], B_w),
                TOL[dt]["y"], f"fem pack spmm m={m_w} {dt} vs its plan's walk")
        k_w = cuda_ms(lambda: tsm.spmm(pk, B_w), 20)
        lib_w = cuda_ms(lambda: torch.sparse.mm(A_w, B_w), 20)
        widths.append(f"m={m_w} {str(dt)[6:]} kernel {k_w:.4f} torch.sparse.mm {lib_w:.4f}")
    say("20 times", "SlabPack spmm at other widths, ms per call: " + "; ".join(widths))

    need_v, of = spmv_need(plans["SlabPack"], csr)
    lib = library_ms(lambda: torch.mv(A_lib, x), 20)
    st = csr.to_strip()
    s_ms = cuda_ms(lambda: tsm.spmv(st, x), 20)
    for label, mat, kernel_fn, plain_fn in (
            ("SlabPack", pk, tsm.spmv, ksl.slab_pack_spmv_ref),
            ("SlabELL", sl, tsm.spmv, ksl.slab_spmv_ref)):
        row = times if label == "SlabPack" else {}       # one JSON row: one kernel, one plan
        k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: kernel_fn(mat, x),
                                               lambda: plain_fn(mat, x), 20)
        b_ms, _ = record(row, "slab_spmv", k_ms, p_ms, need_v, 2 * nnz, lib)
        row["slab_spmv"]["bound_counts"] = of
        per_v = note_steps(row, "slab_spmv", per_step(
            lambda: krg.LAUNCHES, lambda j: [tsm.spmv(mat, x) for _ in range(j)], 1)[
                "slab_spmv"], f"spmv({label}, x) product")
        d_ms = device_us(lambda: kernel_fn(mat, x), 20, "rowgroup_spmv_kernel",
                         lambda: krg.LAUNCHES["slab_spmv"]) / 1e3
        mb, mp = mat.spmv_traffic_bytes() / 1e6, need_v / 1e6
        say("20 times", f"{label} spmv fem f32: kernel {k_ms:.4f} ms per call runs {k_runs}, "
            f"of it {d_ms:.4f} ms on the device (profiler): {mp / d_ms:.1f} GB/s of the plan, "
            f"x and y ({mp:.1f} MB), {mb / d_ms:.1f} GB/s of the layout's {mb:.1f} MB "
            f"spmv_traffic_bytes; plain {p_ms:.4f} ms runs {p_runs}; StripELL kernel on the "
            f"same operator {s_ms:.4f} ms; bound {b_ms:.4f} ms (bytes of the {of}: "
            f"{need_v} against the CSR's {need_bytes(nnz, csr.shape)}); torch.mv on the CSR "
            f"{lib} ms; launches per product {per_v}")
    say("20 times", "host seconds: " + "; ".join(f"{k} {v:.3f}" for k, v in host.items()))


def heavy_row(n=3000):
    """Scattered entries and one row holding every column: the row-group
    SpMV cuts that row into many segments."""
    rng = np.random.default_rng(17)
    m = sp.random(n, n, density=0.002, random_state=rng, format="lil", dtype=np.float32)
    m[17, :] = rng.standard_normal(n).astype(np.float32)
    return m.tocsr()


def well_cases():
    """(label, scipy matrix, k_tile) for the SpMV of a WELL against its plain
    version: tests/test_well.py's matrices, k_tile = 4 overflow tiles, a
    stored zero, nnz = 0 and a heavy row."""
    rng = np.random.default_rng(0)
    rand = lambda r, c, d: sp.random(r, c, density=d, random_state=rng,  # noqa: E731
                                     format="csr", dtype=np.float32)
    cases = [("random 300² 5%", rand(300, 300, 0.05), None),
             ("wide 64x1000", rand(64, 1000, 0.02), None),
             ("tall 1000x64", rand(1000, 64, 0.02), None),
             ("empty rows", sp.csr_matrix((np.ones(3, np.float32), ([0, 5, 290], [250, 3, 12])),
                                          shape=(300, 300)), None)]
    dense_row = sp.lil_matrix((40, 256), dtype=np.float32)
    dense_row[7, :] = rng.standard_normal(256)
    dense_row[3, 5] = 2.5
    zero = sp.random(200, 300, density=0.04, random_state=7, format="csr", dtype=np.float32)
    zero.data[[0, 9, 30]] = 0.0                # stored entries whose value is zero
    return cases + [("dense row", dense_row.tocsr(), None),
                    ("dense row k_tile=4", dense_row.tocsr(), 4),
                    ("k_tile=4 overflow 64x128", sp.random(
                        64, 128, density=0.2, random_state=np.random.default_rng(3),
                        format="csr", dtype=np.float32), 4),
                    ("stored zero", zero, None),
                    ("nnz=0", sp.csr_matrix((50, 70), dtype=np.float32), None),
                    ("heavy row", heavy_row(), None)]


def check_non_finite_x(dev):
    """Where x holds inf or NaN, the row-group SpMV gives scipy's CSR SpMV
    answer through each of its five formats: a stored zero meets inf
    (0 · inf = NaN in both), and a column that only padding slots point at
    holds NaN (no NaN from it, where the plain versions give one)."""
    m = sprinkled(300, 520, 0.03, 11, zeros=(0,)).tocoo()
    keep = m.col != 128                     # under padding slots
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])
    x = np.ones(520, np.float32)
    x[int(m.indices[z])] = np.inf
    x[128] = np.nan
    want = m @ x
    check(np.isnan(want).sum() == 1, "the non-finite case: scipy gives one NaN")
    csr = tsm.CSR.from_scipy(m, device=dev)
    xt = torch.from_numpy(x).to(dev)
    out = {}
    for label, mat, fn, ref in (("well", csr.to_well(), tsm.spmv, kw.well_spmv_ref),
                                ("slab", csr.to_slab(rb=128), tsm.spmv, ksl.slab_spmv_ref),
                                ("pack", csr.to_slab_pack(), tsm.spmv,
                                 ksl.slab_pack_spmv_ref),
                                ("strip", csr.to_strip(), tsm.spmv, ks.strip_spmv_ref),
                                ("slab stream", csr.to_slab_stream(rb=128), tsm.spmv,
                                 ksl.slab_stream_spmv_ref)):
        got = fn(mat, xt).cpu().numpy()
        check(np.array_equal(np.isnan(got), np.isnan(want)),
              f"non-finite x through {label}: NaN where scipy has none, or the reverse")
        ok = np.isfinite(want)
        compare(None, torch.from_numpy(got[ok]), torch.from_numpy(want[ok]), 1e-5,
                f"non-finite x through {label}, finite entries")
        out[label] = (f"{int(np.isnan(got).sum())} NaN as scipy, plain version "
                      f"{int(torch.isnan(ref(mat, xt)).sum())}")
    return out


def stream_cases():
    """(label, scipy matrix, rb) for the SlabStream kernel against its plain
    version: tests/test_gell_pack.py's mixed-degree matrices at their rb, a
    rectangular matrix, an empty one and a stored zero."""
    zero = mixed_degree(600, 3)
    zero.data[[0, 5, 77]] = 0.0
    rect = sp.random(300, 900, 0.02, format="csr", dtype=np.float32,
                     random_state=np.random.default_rng(4))
    return [("mixed 2000 rb=256", mixed_degree(2000, 0), 256),
            ("mixed 1100 rb=128", mixed_degree(1100, 22), 128),
            ("rectangular 300x900 rb=128", rect, 128),
            ("rectangular 900x300 rb=256", rect.T.tocsr(), 256),
            ("empty rb=256", sp.csr_matrix((300, 200), dtype=np.float32), 256),
            ("stored zero rb=128", zero, 128)]


def general_phases(dev, g, times, launches, poisson_csr):
    """Phases 21–24: the WELL and SlabStream kernels against their plain
    versions, and the general-matrix path at full size (the circuit operator
    through WELL, the FEM operator through SlabStream, rmatvec, auto_format).
    Adds the two kernels' times and main-path launches to ``times`` and
    ``launches``."""
    # 21 -----------------------------------------------------------------------
    worst = {}
    for label, m, k_tile in well_cases():
        well = tsm.CSR.from_scipy(m, device=dev).to_well(k_tile=k_tile)
        check(well.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        xs = torch.randn(m.shape[1], generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            w_dt = well.astype(dt)
            x_dt = xs.to(torch.float32 if dt == torch.bfloat16 else dt)
            y, y_ref = tsm.spmv(w_dt, x_dt), kw.well_spmv_ref(w_dt, x_dt)
            check(y.dtype == y_ref.dtype, f"{label}: dtype {y.dtype} vs {y_ref.dtype}")
            errs.append(compare("well_spmv", y, y_ref, TOL[dt]["y"], f"well {label} {dt}"))
        worst[f"{label} (K {well.k_tile}, {well.n_tiles} tiles)"] = max(errs)
        plan = krg.plan_of(well)
        if label == "heavy row":            # the heavy row's group takes the partials path
            check(plan.spmv.n_multi > 0, "the heavy row was not cut into segments")
            y = tsm.spmv(well, xs)
            compare(None, y, krg.spmv_walk(plan, xs), 1e-5, "heavy row vs its plan's walk")
            check(all(torch.equal(tsm.spmv(well, xs), y) for _ in range(5)),
                  "heavy row: reruns differ")
            heavy = (f"heavy row: {int(plan.spmv.multi[:, 2].max())} segments of at most "
                     f"{plan.spmv.seg_cols} union columns, reruns bitwise equal")
        if label == "empty rows":
            empty = int((plan.grp_ptr[1:] == plan.grp_ptr[:-1]).sum())
            check(empty > 0, "the empty-rows case has no empty group")
    nonfinite = check_non_finite_x(dev)
    torch.cuda.synchronize()
    say("21 well", "kernel vs plain within tolerance (f32, f64, bf16 values); worst rel err "
        "per case: " + "; ".join(f"{w} {e:.2e}" for w, e in worst.items())
        + f"; {heavy}; empty rows: {empty} empty groups; non-finite x: {nonfinite}")

    # 22 -----------------------------------------------------------------------
    worst = {}
    for label, m, rb in stream_cases():
        st = tsm.CSR.from_scipy(m, device=dev).to_slab_stream(rb=rb)
        check(st.n_non_zero_entries() == m.nnz, f"{label}: nnz")
        xs = torch.randn(m.shape[1], generator=g, device=dev)
        errs = []
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            s_dt = st.astype(dt)
            x_dt = xs.to(torch.float32 if dt == torch.bfloat16 else dt)
            y, y_ref = tsm.spmv(s_dt, x_dt), ksl.slab_stream_spmv_ref(s_dt, x_dt)
            check(y.dtype == y_ref.dtype, f"{label}: dtype {y.dtype} vs {y_ref.dtype}")
            errs.append(compare("slab_stream_spmv", y, y_ref, TOL[dt]["y"],
                                f"slab stream {label} {dt}"))
            compare(None, y, krg.spmv_walk(krg.plan_of(s_dt), x_dt), TOL[dt]["y"],
                    f"slab stream {label} {dt} vs its plan's walk")
        worst[f"{label} ({st.n_chunks} chunks)"] = max(errs)
    torch.cuda.synchronize()
    say("22 slab stream", "kernel vs plain and vs its plan's walk within tolerance (f32, "
        "f64, bf16 values); worst rel err vs plain per case: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items()))

    # 23 -----------------------------------------------------------------------
    host = {}
    m = (matgen.circuit_scatter(seed=SEED) * 2e-2).tocsr()
    m.sort_indices()
    n = m.shape[0]
    krg.reset_launches()
    report = {}

    def solved(label, x_, info, A_csr, b_):
        rel = true_rel(A_csr, x_, b_)
        check(bool(info.converged), f"{label} did not converge in {int(info.iterations)}")
        check(rel <= SOLVE_TRUE_REL, f"{label}: true relative residual {rel:.3e} > {SOLVE_TRUE_REL}")
        report[label] = (int(info.iterations), rel)

    with tempfile.TemporaryDirectory() as td:
        mtx, npz = os.path.join(td, "circuit.mtx"), os.path.join(td, "circuit_well.npz")
        tio.save_mtx(tsm.CSR.from_scipy(m, device="cpu"), mtx)
        csr = tio.load_mtx(mtx)                      # no device: the current card
        check(csr.data.device == dev, f"load_mtx without device= gave {csr.data.device}")
        t0 = time.perf_counter()
        well = csr.to_well()
        torch.cuda.synchronize()
        host["to_well"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wplan = krg.plan_of(well)
        wplan.spmv
        torch.cuda.synchronize()
        host["WELL plan"] = time.perf_counter() - t0
        checkpoint.save_matrix(npz, well)
        well2 = checkpoint.load_matrix(npz)          # no device: the current card
    check(isinstance(well2, tsm.WELL) and well2.vals.device == dev,
          "load_matrix did not give a WELL on the card")
    x = torch.randn(n, generator=g, device=dev)
    y = tsm.spmv(well, x)
    check(torch.equal(tsm.spmv(well2, x), y), "the reloaded WELL's spmv differs")
    check(torch.equal(tsm.spmv(csr, x, method="pallas"), y),
          "spmv(method='pallas') differs from spmv(WELL)")
    e_csr = compare(None, y, tsm.spmv(csr, x), 1e-5, "circuit spmv WELL kernel vs CSR stream")
    e_walk = compare(None, y, krg.spmv_walk(wplan, x), 1e-5, "circuit WELL kernel vs its plan's walk")
    b = torch.randn(n, generator=g, device=dev)
    x_bi, info_bi = solvers.bicgstab(well, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    solved("BiCGStab WELL", x_bi, info_bi, csr, b)
    solved("GMRES(30) WELL", *solvers.gmres(well, b, tol=0.0, rtol=SOLVE_RTOL, restart=30,
                                            maxiter=3000), csr, b)
    yt = torch.randn(n, generator=g, device=dev)
    r = tsm.rmatvec(well, yt)
    e_rmv = compare(None, r.cpu(), torch.from_numpy(m.T.astype(np.float64)
                                                    @ yt.double().cpu().numpy()),
                    1e-5, "circuit rmatvec vs scipy Aᵀy")

    rows, cols, vals, nf, _ = fem_triplets()
    fcsr = tsm.CSR.from_host_coo(rows, cols, vals, (nf, nf), device=dev)
    del rows, cols, vals
    t0 = time.perf_counter()
    st = fcsr.to_slab_stream()
    torch.cuda.synchronize()
    host["to_slab_stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    splan = krg.plan_of(st)
    splan.spmv
    torch.cuda.synchronize()
    host["SlabStream plan"] = time.perf_counter() - t0
    fst = fcsr.to_strip()
    t0 = time.perf_counter()
    fpk = fcsr.to_slab_pack()
    torch.cuda.synchronize()
    host["to_slab_pack"] = time.perf_counter() - t0
    for label, other in (("StripELL", fst), ("SlabPack", fpk)):
        oplan = krg.plan_of(other)
        check(oplan.group == splan.group and all(
            torch.equal(getattr(oplan, f), getattr(splan, f))
            for f in ("grp_ptr", "cols", "mask", "vals")),
              f"the FEM SlabStream's plan and its {label}'s differ")
    xf = torch.randn(nf, generator=g, device=dev)
    yf = tsm.spmv(st, xf)
    check(torch.equal(tsm.spmv(fst, xf), yf), "FEM spmv over StripELL and SlabStream differ")
    check(torch.equal(tsm.spmv(fpk, xf), yf), "FEM spmv over SlabPack and SlabStream differ")
    e_fcsr = compare(None, yf, tsm.spmv(fcsr, xf), 1e-5, "fem spmv SlabStream kernel vs CSR")
    e_swalk = compare(None, yf, krg.spmv_walk(splan, xf), 1e-5,
                      "fem SlabStream kernel vs its plan's walk")
    bf = torch.randn(nf, generator=g, device=dev)
    Mj = solvers.JacobiPreconditioner.from_matrix(fcsr)
    x_pcg, info_pcg = solvers.cg(st, bf, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000, M=Mj)
    solved("PCG(Jacobi) SlabStream", x_pcg, info_pcg, fcsr, bf)
    x_pcg_s, info_pcg_s = solvers.cg(fst, bf, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000, M=Mj)
    check(torch.equal(x_pcg_s, x_pcg) and int(info_pcg_s.iterations) == int(info_pcg.iterations),
          "PCG(Jacobi) over StripELL and over SlabStream differ")
    del fpk
    with tempfile.TemporaryDirectory() as td:
        npz = os.path.join(td, "fem_slab_stream.npz")
        checkpoint.save_matrix(npz, st)
        st2 = checkpoint.load_matrix(npz)
    check(isinstance(st2, tsm.SlabStream) and torch.equal(tsm.spmv(st2, xf), yf),
          "the reloaded SlabStream's spmv differs")
    torch.cuda.synchronize()
    launches["well_spmv"] = krg.LAUNCHES["well_spmv"]
    launches["slab_stream_spmv"] = krg.LAUNCHES["slab_stream_spmv"]
    for name in ("well_spmv", "slab_stream_spmv"):
        check(launches[name] > 0, f"the general path launched {name} no time")

    picks = {}
    for label, A_, want in (("Poisson 2048²", poisson_csr, "DIA"), ("FEM", fcsr, "StripELL"),
                            ("circuit", csr, "RouteStream")):
        t0 = time.perf_counter()
        got = type(tsm.auto_format(A_)).__name__
        picks[label] = (got, time.perf_counter() - t0)
        check(got == want, f"auto_format picked {got} for the {label} operator, not {want}")

    full = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        w_dt, s_dt = well.astype(dt), st.astype(dt)
        full[f"well {dt}"] = compare("well_spmv", tsm.spmv(w_dt, x.to(dt)),
                                     kw.well_spmv_ref(w_dt, x.to(dt)), tol, f"circuit WELL {dt}")
        full[f"slab stream {dt}"] = compare(
            "slab_stream_spmv", tsm.spmv(s_dt, xf.to(dt)),
            ksl.slab_stream_spmv_ref(s_dt, xf.to(dt)), tol, f"fem SlabStream {dt}")
        del w_dt, s_dt
    say("23 general path", f"circuit_scatter·2e-2: {n} rows, {csr.n_non_zero_entries()} "
        f"entries, load_mtx and load_matrix without device= on {csr.data.device}; WELL: "
        f"{well.n_tiles} tiles, K {well.k_tile}, nse {well.nse}, fill {well.fill_ratio():.4f}, "
        f"spmv_traffic_bytes {well.spmv_traffic_bytes()}; spmv vs CSR {e_csr:.2e}, vs the "
        f"plan's walk {e_walk:.2e}, "
        f"method='pallas' and the reloaded WELL bitwise equal; rmatvec vs scipy {e_rmv:.2e}. "
        f"FEM (phase 10's SPD operator): {nf} rows, {fcsr.n_non_zero_entries()} entries; "
        f"SlabStream: {st.n_chunks} chunks, nse {st.nse}, fill {st.fill_ratio():.4f}, "
        f"spmv_traffic_bytes {st.spmv_traffic_bytes()}; its plan is the StripELL's and the "
        f"SlabPack's, array for array; spmv over SlabStream, StripELL and SlabPack bitwise "
        f"equal, vs CSR {e_fcsr:.2e}, vs the plan's walk {e_swalk:.2e}; PCG(Jacobi) over "
        f"SlabStream and StripELL bitwise equal ({int(info_pcg.iterations)} iterations "
        f"each); reloaded SlabStream bitwise equal. Kernels vs plain at full size: "
        + "; ".join(f"{k} {v:.2e}" for k, v in full.items())
        + f". Solves to rtol {SOLVE_RTOL} (iterations, true relative residual f64): "
        + "; ".join(f"{k} {it} {rr:.3e}" for k, (it, rr) in report.items())
        + "; auto_format: " + "; ".join(f"{k} → {v} ({t:.3f} s)" for k, (v, t) in picks.items())
        + f"; launches {({k: launches[k] for k in ('well_spmv', 'slab_stream_spmv')})}")

    say("23 general path", plan_line("WELL", wplan, host["WELL plan"]))
    say("23 general path", plan_line("FEM SlabStream", splan, host["SlabStream plan"]))
    check(torch.equal(tsm.spmv(well, x), y), "WELL spmv rerun differs")
    check(torch.equal(tsm.spmv(st, xf), yf), "SlabStream spmv rerun differs")
    check(torch.equal(tsm.rmatvec(well, yt), r), "rmatvec rerun differs")
    x_bi2, info_bi2 = solvers.bicgstab(well, b, tol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    check(torch.equal(x_bi2, x_bi) and torch.equal(info_bi2.residual_norm,
                                                   info_bi.residual_norm),
          "BiCGStab over WELL rerun differs")
    say("23 determinism", "WELL spmv, SlabStream spmv, rmatvec and BiCGStab over WELL rerun "
        "bitwise equal")

    # 24 -----------------------------------------------------------------------
    for name, mat, plan, xv, A_csr, kern, plain in (
            ("well_spmv", well, wplan, x, csr, tsm.spmv, kw.well_spmv_ref),
            ("slab_stream_spmv", st, splan, xf, fcsr, tsm.spmv,
             ksl.slab_stream_spmv_ref)):
        nnz_ = A_csr.n_non_zero_entries()
        k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: kern(mat, xv), lambda: plain(mat, xv), 20)
        d_ms = device_us(lambda: kern(mat, xv), 20, "rowgroup_spmv_kernel",
                         lambda: krg.LAUNCHES[name]) / 1e3
        A_lib = torch_csr(A_csr)
        lib = library_ms(lambda: torch.mv(A_lib, xv), 20)
        del A_lib
        mb = mat.spmv_traffic_bytes() / 1e6
        mp = (plan.nbytes + sum(A_csr.shape) * 4) / 1e6    # the plan, x and y once each
        need, of = spmv_need(plan, A_csr)
        b_ms, by = record(times, name, k_ms, p_ms, need, 2 * nnz_, lib)
        times[name]["bound_counts"] = of
        c_ms = cuda_ms(lambda: tsm.spmv(A_csr, xv), 20)
        say("24 times", f"{name} f32: kernel {k_ms:.4f} ms per call ({nnz_ / k_ms / 1e6:.3f} "
            f"Gnnz/s) runs {k_runs}, of it {d_ms:.4f} ms on the device (profiler): "
            f"{mp / d_ms:.1f} GB/s of the plan, x and y ({mp:.1f} MB), {mb / d_ms:.1f} GB/s of "
            f"the layout's {mb:.1f} MB spmv_traffic_bytes; plain {p_ms:.4f} ms runs {p_runs}; "
            f"bound {b_ms:.4f} ms ({by}, of the {of}'s {need} bytes; the CSR's "
            f"{need_bytes(nnz_, A_csr.shape)}); torch.mv on the CSR {lib} ms; the port's CSR "
            f"stream path {c_ms:.4f} ms")
    plain_w = lambda v: kw.well_spmv_ref(well, v)  # noqa: E731
    runs = [bicgstab_iters_per_s(plain_w, b, 32), bicgstab_iters_per_s(well, b, 128),
            bicgstab_iters_per_s(well, b, 128), bicgstab_iters_per_s(plain_w, b, 32)]
    say("24 times", f"BiCGStab f32 circuit WELL: kernel {(runs[1] + runs[2]) / 2:.1f} iters/s "
        f"runs {runs[1:3]}; plain {(runs[0] + runs[3]) / 2:.1f} iters/s "
        f"runs {[runs[0], runs[3]]}")
    plain_s = lambda v: ksl.slab_stream_spmv_ref(st, v)  # noqa: E731
    runs = [cg_iters_per_s(plain_s, bf, 64, Mj), cg_iters_per_s(st, bf, 256, Mj),
            cg_iters_per_s(st, bf, 256, Mj), cg_iters_per_s(plain_s, bf, 64, Mj)]
    say("24 times", f"PCG(Jacobi) f32 fem SlabStream: kernel {(runs[1] + runs[2]) / 2:.1f} "
        f"iters/s runs {runs[1:3]}; plain {(runs[0] + runs[3]) / 2:.1f} iters/s "
        f"runs {[runs[0], runs[3]]}")
    per_w = note_steps(times, "well_spmv", per_step(
        lambda: krg.LAUNCHES, lambda j: solvers.bicgstab(well, b, tol=0.0, maxiter=j), 32,
        well)["well_spmv"], "BiCGStab iteration, circuit WELL")
    per_s = note_steps(times, "slab_stream_spmv", per_step(
        lambda: krg.LAUNCHES, lambda j: solvers.cg(st, bf, tol=0.0, maxiter=j, M=Mj), 32,
        st)["slab_stream_spmv"], "PCG(Jacobi) iteration, FEM SlabStream")
    say("24 times", "host seconds: " + "; ".join(f"{k} {v:.3f}" for k, v in host.items())
        + f"; launches per iteration: well_spmv per BiCGStab {per_w}, slab_stream_spmv per "
        f"PCG {per_s}")


def scipy_csr(csr):
    """A port CSR as a scipy CSR on the host (its valid entries)."""
    nnz = csr.n_non_zero_entries()
    return sp.csr_matrix((csr.data[:nnz].cpu().numpy(), csr.indices[:nnz].cpu().numpy(),
                          csr.indptr.cpu().numpy()), shape=csr.shape)


def same_as_scipy(csr, ref, what):
    """The port's result, pruned of padding and zeros, equal to scipy's in
    structure and values."""
    got = scipy_csr(csr.prune(keep_zeros=False))
    ref = ref.tocsr()
    ref.eliminate_zeros()
    ref.sort_indices()
    check(np.array_equal(got.indptr, ref.indptr) and np.array_equal(got.indices, ref.indices),
          f"{what}: structure differs from scipy")
    check(np.array_equal(got.data, ref.data.astype(got.data.dtype)),
          f"{what}: values differ from scipy")


def timed(fn):
    """(result, wall seconds, CUDA-event seconds) of one call."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def sparse_mm_yardstick(csr):
    """``torch.sparse.mm`` of the operator's CUDA CSR tensor with itself, the
    library's SpGEMM: its seconds (CUDA events, the second of two calls)
    and output nnz, or its error.  A yardstick only: no path of the port
    calls it, so its failure is printed, not raised."""
    try:
        T = torch_csr(csr)
        torch.sparse.mm(T, T)
        out, _, secs = timed(lambda: torch.sparse.mm(T, T))
        nnz = int(out._nnz())
        del out, T
        return f"{secs:.4f} s, out nnz {nnz}"
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:   # the library's own failure
        return f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    finally:
        torch.cuda.empty_cache()


def gs_sweep_host(m, b, x):
    """One Gauss–Seidel sweep row by row in f64 on the host: the reference's
    update, x_i ← (b_i − Σ_{j≠i} a_ij x_j) / a_ii with the new x_j for j < i."""
    m = m.tocsr().astype(np.float64)
    x = np.array(x, np.float64)
    diag = m.diagonal()
    ip, ind, dat = m.indptr, m.indices, m.data
    for i in range(m.shape[0]):
        lo, hi = ip[i], ip[i + 1]
        s = float(dat[lo:hi] @ x[ind[lo:hi]]) - diag[i] * x[i]
        x[i] = (b[i] - s) / diag[i]
    return x


def algebra_phases(dev, g):
    """Phases 25–28: the matrix algebra on the FEM operator, SpGEMM of the
    circuit and of the FEM operator at full size (ESC path), and SOR /
    Gauss–Seidel over the level schedule.  No CUDA kernel of the port runs
    here: these are PyTorch ops on the card."""
    t_start = time.perf_counter()
    fem = matgen.fem_block_band(seed=SEED).astype(np.float32).tocsr()
    fem.sort_indices()
    circ = matgen.circuit_scatter(seed=SEED).astype(np.float32).tocsr()
    circ.sort_indices()
    A = tsm.CSR.from_scipy(fem, device=dev)
    C = tsm.CSR.from_scipy(circ, device=dev)

    # 25 -----------------------------------------------------------------------
    secs = {}
    At, _, secs["transpose"] = timed(lambda: tsm.transpose(A))
    same_as_scipy(At, fem.T, "transpose")
    S, _, secs["add(A, A.T)"] = timed(lambda: tsm.add(A, At))
    same_as_scipy(S, fem + fem.T, "add(A, A.T)")
    D, _, secs["sub(A, A.T)"] = timed(lambda: tsm.sub(A, At))
    same_as_scipy(D, fem - fem.T, "sub(A, A.T)")
    Z, _, secs["A - A"] = timed(lambda: A - A)
    same_as_scipy(Z, fem - fem, "A - A")
    check(Z.nse == 2 * A.nse and float(Z.data.abs().max()) == 0.0, "A - A: not all stored zeros")
    sym_fem, _, secs["is_symmetric(FEM)"] = timed(lambda: bool(tsm.is_symmetric(A)))
    bent = circ.copy()
    bent.data[bent.indptr[1000]] += 1.0              # one value of row 1000 moved
    B = tsm.CSR.from_scipy(bent, device=dev)
    sym_circ, _, secs["is_symmetric(circuit, perturbed)"] = timed(
        lambda: bool(tsm.is_symmetric(B)))
    sym_circ_raw = bool(tsm.is_symmetric(C))
    check(sym_fem and not sym_circ and not sym_circ_raw, "is_symmetric answers")
    srt, _, secs["is_sorted"] = timed(lambda: bool(tsm.is_sorted(A)))
    check(srt, "is_sorted(FEM)")
    i_row = A.shape[0] // 2
    row, _, secs["extract_row"] = timed(lambda: tsm.extract_row(A, i_row))
    lo, hi = fem.indptr[i_row], fem.indptr[i_row + 1]
    check(np.array_equal(row.indices, fem.indices[lo:hi])
          and np.array_equal(row.vals, fem.data[lo:hi]), "extract_row")
    say("25 algebra", f"FEM {A.shape[0]} rows, {A.n_non_zero_entries()} entries, f32: "
        f"transpose, add(A, A.T), sub(A, A.T) and A - A equal to scipy (structure and "
        f"values); is_symmetric FEM {sym_fem}, circuit {sym_circ_raw}, circuit with a "
        f"value moved {sym_circ}; is_sorted {srt}; extract_row({i_row}) {row.nnz} entries; "
        f"seconds (CUDA events): " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()))
    del At, S, D, Z, B

    # 26 -----------------------------------------------------------------------
    kb = C.max_row_nnz()
    check(C.nse * kb > (1 << 25), "the circuit A·A would not take the ESC path")
    out, wall_c, ev_c = timed(lambda: tsm.spgemm(C, C))
    out2, wall_w, ev_w = timed(lambda: tsm.spgemm(C, C))
    check(all(torch.equal(getattr(out, f), getattr(out2, f))
              for f in ("indptr", "indices", "data", "row_ids")), "circuit A·A rerun differs")
    t0 = time.perf_counter()
    ref = circ @ circ
    t_scipy = time.perf_counter() - t0
    got = scipy_csr(out.prune(keep_zeros=False))
    ref.sort_indices()
    err = abs(got.astype(np.float64) - ref).max() if ref.nnz else 0.0
    rel = err / abs(ref).max()
    check(rel <= 1e-5, f"circuit A·A: rel err {rel:.3e} > 1e-5")
    # scipy drops exact zeros; a coordinate whose sum cancels to 0 in one
    # order only shows as a structure difference, and must be tiny
    same = (np.array_equal(got.indptr, ref.indptr) and np.array_equal(got.indices, ref.indices))
    apart = 0 if same else int(abs((got != 0).astype(np.int8) - (ref != 0).astype(np.int8)).sum())
    check(apart <= 16, f"circuit A·A: {apart} coordinates differ from scipy's structure")
    plan = tsm.ops.algebra.esc_plan(C, C)
    say("26 spgemm circuit", f"A·A of {C.shape[0]} rows, {C.n_non_zero_entries()} entries "
        f"(longest row {kb}): ESC, {plan.n_candidates} candidates in {plan.n_parts} part(s); "
        f"out nse {out.nse} ({got.nnz} nonzero), structure equal to scipy's "
        f"{'exactly' if same else f'but for {apart} cancelled sums'}, values rel err "
        f"{rel:.2e}; rerun bitwise equal; cold {wall_c:.4f} s wall ({ev_c:.4f} events), warm "
        f"{wall_w:.4f} s wall ({ev_w:.4f} events), {out.nse / wall_w / 1e6:.1f} M out-nnz/s "
        f"warm; scipy A @ A on the host {t_scipy:.4f} s; torch.sparse.mm "
        f"{sparse_mm_yardstick(C)}")
    del out, out2

    # 27 -----------------------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    plan, plan_s, _ = timed(lambda: tsm.ops.algebra.esc_plan(A, A))
    check(plan.n_candidates == FEM_CANDIDATES, f"FEM candidates {plan.n_candidates}")
    widest = int(max(plan.cand_ptr[b] - plan.cand_ptr[a]
                     for a, b in zip(plan.row_cuts[:-1], plan.row_cuts[1:])))
    n_parts = plan.n_parts
    del plan
    P, wall_c, ev_c = timed(lambda: tsm.spgemm(A, A))
    peak = torch.cuda.max_memory_allocated() - base_mem
    P2, wall_w, ev_w = timed(lambda: tsm.spgemm(A, A))
    check(all(torch.equal(getattr(P, f), getattr(P2, f))
              for f in ("indptr", "indices", "data", "row_ids")), "FEM A·A rerun differs")
    del P2
    v = torch.randn(A.shape[1], generator=g, device=dev)
    cv = tsm.spmv(P, v)
    rv = tsm.spmv(A, tsm.spmv(A, v))
    e_probe = compare(None, cv, rv, 1e-4, "FEM A·A probe C·v vs A·(A·v)")
    nse = P.nse
    del P
    say("27 spgemm fem", f"A·A of {A.shape[0]} rows, {A.n_non_zero_entries()} entries: ESC, "
        f"{FEM_CANDIDATES} candidates in {n_parts} parts of at most "
        f"{tsm.ops.algebra._SPGEMM_PART_SLOTS} (the largest {widest}); plan {plan_s:.4f} s; "
        f"cold {wall_c:.4f} s wall ({ev_c:.4f} events), expand/sort/compress "
        f"{wall_c - plan_s:.4f} s; warm {wall_w:.4f} s wall ({ev_w:.4f} events), expand/sort/"
        f"compress {wall_w - plan_s:.4f} s; out nse {nse}, {nse / wall_w / 1e6:.1f} M "
        f"out-nnz/s warm; probe C·v vs A·(A·v) rel err {e_probe:.2e}; rerun bitwise equal; "
        f"peak device memory {peak / 2**30:.2f} GiB above the operand; torch.sparse.mm "
        f"{sparse_mm_yardstick(A)}")
    torch.cuda.empty_cache()

    # 28 -----------------------------------------------------------------------
    rows, cols, vals, n, _ = fem_triplets()
    spd = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    spd.sum_duplicates()
    spd.sort_indices()
    S = tsm.CSR.from_scipy(spd, device=dev)
    b = tsm.spmv(S, torch.randn(n, generator=g, device=dev))
    x0 = torch.zeros(n, device=dev)
    (x1, _), sched_s, _ = timed(lambda: solvers.gauss_seidel(S, b, x0, maxiter=1))
    sched = solvers.sor_schedule(S)
    want = gs_sweep_host(spd, b.double().cpu().numpy(), np.zeros(n))
    e_sweep = compare(None, x1.cpu(), torch.from_numpy(want), 1e-5,
                      "FEM Gauss-Seidel sweep vs host")
    kern = [len(device_kernels(lambda: solvers.gauss_seidel(S, b, x0, maxiter=k)))
            for k in (1, 2)]
    (x20, info20), wall20, _ = timed(lambda: solvers.gauss_seidel(S, b, x0, tol=0.0,
                                                                   maxiter=20))
    check(int(info20.iterations) == 20, "20 sweeps")
    r20, bn = host_residual(S, x20, b)
    r0 = float(np.linalg.norm(b.double().cpu().numpy()))
    x20b, _ = solvers.gauss_seidel(S, b, x0, tol=0.0, maxiter=20)
    check(torch.equal(x20b, x20), "FEM Gauss-Seidel rerun differs")
    say("28 sor", f"FEM SPD {n} rows: level schedule {sched.n_levels} levels (widest "
        f"{max(b_ - a_ for a_, b_ in zip(sched.row_ptr[:-1], sched.row_ptr[1:]))} rows), "
        f"first solve with its schedule {sched_s:.4f} s; one Gauss-Seidel sweep vs the host "
        f"row loop (f64) rel err {e_sweep:.2e}; 20 sweeps {wall20 / 20 * 1e3:.2f} ms a sweep "
        f"with its residual, {kern[1] - kern[0]} device kernels a sweep ({kern[0]} in a "
        f"1-sweep solve); true residual (f64 host) {r20:.4e} of ‖b‖ {bn:.4e} (x0 = 0: "
        f"{r0:.4e}); rerun bitwise equal")
    pr, pc, pv = poisson_triplets(128)
    lap = sp.csr_matrix((pv, (pr, pc)))                  # 128² rows
    bp = np.random.default_rng(SEED).standard_normal(lap.shape[0])
    P_dev = tsm.CSR.from_scipy(lap, device=dev)
    P_cpu = tsm.CSR.from_scipy(lap, device="cpu")
    b_dev = torch.from_numpy(bp).to(dev)
    (xs, info), t_dev, _ = timed(lambda: solvers.sor(P_dev, b_dev, rtol=1e-6, maxiter=10_000,
                                                       omega=1.9))
    check(bool(info.converged), f"128² SOR did not converge in {int(info.iterations)}")
    t0 = time.perf_counter()
    xc, info_c = solvers.sor(P_cpu, torch.from_numpy(bp), rtol=1e-6, maxiter=10_000, omega=1.9)
    t_cpu = time.perf_counter() - t0
    check(int(info.iterations) == int(info_c.iterations),
          f"128² SOR iterations {int(info.iterations)} on the card, {int(info_c.iterations)} "
          "on the CPU path")
    e_cpu = compare(None, xs.cpu(), xc, 1e-5, "128² SOR card vs CPU path")
    xs2, info2 = solvers.sor(P_dev, b_dev, rtol=1e-6, maxiter=10_000, omega=1.9)
    check(torch.equal(xs2, xs) and int(info2.iterations) == int(info.iterations),
          "128² SOR rerun differs")
    r_true = np.linalg.norm(bp - lap @ xs.cpu().numpy()) / np.linalg.norm(bp)
    say("28 sor", f"128² Poisson f64, omega 1.9, rtol 1e-6: {int(info.iterations)} sweeps "
        f"({solvers.sor_schedule(P_dev).n_levels} levels), {t_dev:.3f} s on the card "
        f"({t_dev / int(info.iterations) * 1e3:.2f} ms a sweep), the CPU path {t_cpu:.3f} s "
        f"with the same count, iterate rel err {e_cpu:.2e}; true relative residual "
        f"{r_true:.2e}; rerun bitwise equal")
    say("25-28 total", f"{time.perf_counter() - t_start:.1f} s")


def full(v):
    """A sharded vector (DTensor) read whole, or a tensor as it is."""
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def shard_need(plan):
    """(bytes, "plan" or "CSR"): what an SpMV over a shard's row-group plan
    needs (``spmv_need`` on the shard's own shape and entries)."""
    n_rows, n_cols = plan.shape
    of_csr = need_bytes(plan.nnz, plan.shape)
    of_plan = plan.nbytes + (n_rows + n_cols) * 4
    return (of_plan, "plan") if of_plan < of_csr else (of_csr, "CSR")


def block_matvec(d):
    """DistDIA's shard product on the rank's plain block at a world of one,
    with no DTensor around it: the band kernel over the zero-padded block.
    A CG through it shows what the DTensor vectors cost."""
    h = d.halo
    return lambda v: kd.dia_spmv(d.shard, torch.nn.functional.pad(v, (h, h)))


def reset_all_launches():
    for module in (kd, krg, pdist, kk):
        module.reset_launches()


def dist_phases(dev, g, times, launches, csr, dia, b, x_cg):
    """Phases 29-30: PartitionedBuilder, the mesh and the distribution
    layer at a world of one rank under NCCL, on the 2048² Poisson operator
    of phase 4 (``csr``, ``dia``, its right-hand side ``b`` and 200-iteration
    CG iterate ``x_cg``) and the FEM SPD operator of phase 10.  Adds the
    dist_* rows to ``times`` and ``launches``."""
    # 29 -----------------------------------------------------------------------
    n = int(round(csr.shape[0] ** 0.5))
    m = n * n
    rows, cols, vals = poisson_triplets(n)
    t0 = time.perf_counter()
    pb = tsm.PartitionedBuilder(4, m)
    blk = np.minimum(rows // pb.rows_per_block, pb.n_blocks - 1)
    for k in range(pb.n_blocks):
        on = blk == k
        pb.blocks[k].add_batch(rows[on] - k * pb.rows_per_block, cols[on], vals[on])
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcsr = pb.to_csr(device=dev)
    torch.cuda.synchronize()
    t_freeze = time.perf_counter() - t0
    check(pb.shape == csr.shape and pb.nnz == csr.n_non_zero_entries(), "PartitionedBuilder shape")
    for f in ("indptr", "indices", "data", "row_ids"):
        check(torch.equal(getattr(pcsr, f), getattr(csr, f)),
              f"PartitionedBuilder CSR {f} differs from SparseBuilder's")
    del rows, cols, vals, blk, pb
    t0 = time.perf_counter()
    mesh = parallel.make_mesh()
    t_mesh = time.perf_counter() - t0
    check(torch.distributed.get_backend() == "nccl", "the mesh's process group is not NCCL")
    check(mesh.device_type == "cuda" and mesh.size() == 1, f"mesh {mesh}")
    t0 = time.perf_counter()
    line = dryrun_multichip(1)
    t_dry = time.perf_counter() - t0
    say("29 partition", f"PartitionedBuilder(4 blocks) {n}² Poisson: add {t_add:.3f} s, to_csr "
        f"{t_freeze:.3f} s, CSR bitwise equal to SparseBuilder's; make_mesh() {t_mesh:.3f} s: "
        f"{mesh.device_type} {dict(zip(mesh.mesh_dim_names, mesh.shape))} backend "
        f"{torch.distributed.get_backend()}; process_info {parallel.process_info()}; "
        f"{line} ({t_dry:.3f} s)")

    # 30 -----------------------------------------------------------------------
    reset_all_launches()
    host = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host[label] = time.perf_counter() - t
        return out

    def matvec(d, x):
        return full(d.unpad(d.matvec(d.padded_vector(x, mesh), mesh)))

    # DistDIA on the 2048² Poisson operator
    dA = timed("distribute_dia", lambda: parallel.distribute_dia(dia, mesh))
    timed("DistDIA plan", dA.shard_plan)
    x = torch.randn(m, generator=g, device=dev)
    y_dist = matvec(dA, x)
    e_dia = compare(None, y_dist, tsm.spmv(dia, x), 1e-5, "DistDIA spmv vs spmv(DIA)")
    e_dia_ref = compare(None, y_dist, kd.dia_spmv_ref(dia, x), 1e-5,
                        "DistDIA spmv vs the plain DIA SpMV")
    check(torch.equal(matvec(dA, x), y_dist), "DistDIA spmv rerun differs")
    bs = dA.padded_vector(b, mesh)

    def dist_cg(d, rhs, k=200):
        return solvers.cg(lambda v: d.matvec(v, mesh), rhs, tol=0.0, maxiter=k)

    xd, info = dist_cg(dA, bs)
    check(int(info.iterations) == 200, "DistDIA CG iterations")
    xd = full(dA.unpad(xd))
    e_cg = compare(None, xd, x_cg, 1e-4, "DistDIA CG x vs phase 4's CG")
    r_true, b_norm = host_residual(csr, xd, b)
    xd2, info2 = dist_cg(dA, bs)
    check(torch.equal(full(dA.unpad(xd2)), xd)
          and float(info2.residual_norm) == float(info.residual_norm), "DistDIA CG rerun differs")

    # the FEM SPD operator of phase 10 through the four general formats
    frows, fcols, fvals, nf, _ = fem_triplets()
    fcsr = tsm.CSR.from_host_coo(frows, fcols, fvals, (nf, nf), dtype=torch.float32, device=dev)
    del frows, fcols, fvals
    fem = scipy_csr(fcsr)
    xf = torch.randn(nf, generator=g, device=dev)
    yf_csr = tsm.spmv(fcsr, xf)
    yf_sp = torch.from_numpy(fem @ xf.double().cpu().numpy()).to(dev)
    made = {"DistCSR": lambda: parallel.distribute_csr(fcsr, mesh),
            "DistELL": lambda: parallel.distribute_csr(fcsr, mesh, format="ell"),
            "DistCSRSubset": lambda: parallel.distribute_csr_subset(fcsr, mesh),
            "DistSlab": lambda: parallel.distribute_slab(fcsr, mesh, rb=128)}
    dists, errs = {}, {}
    for label, make in made.items():
        d = timed(f"distribute {label}", make)
        timed(f"{label} plan", d.shard_plan)
        y = matvec(d, xf)
        errs[label] = (compare(None, y, yf_csr, 1e-5, f"{label} spmv vs spmv(CSR)"),
                       compare(None, y, yf_sp, 1e-5, f"{label} spmv vs scipy"))
        check(torch.equal(matvec(d, xf), y), f"{label} spmv rerun differs")
        dists[label] = d
    bf = torch.randn(nf, generator=g, device=dev)
    x_ref, _ = solvers.cg(fcsr, bf, tol=0.0, maxiter=200)
    cg_errs = {}
    for label in ("DistSlab", "DistCSRSubset"):
        d = dists[label]
        bfs = d.padded_vector(bf, mesh)
        xs, info_f = dist_cg(d, bfs)
        xs = full(d.unpad(xs))
        cg_errs[label] = compare(None, xs, x_ref, 1e-4, f"{label} CG x vs the CG over the CSR")
        xs2, _ = dist_cg(d, bfs)
        check(torch.equal(full(d.unpad(xs2)), xs), f"{label} CG rerun differs")
    torch.cuda.synchronize()
    run = dict(pdist.LAUNCHES)
    for name, count in run.items():
        check(count > 0, f"the distributed path launched {name} no time")
    launches.update(run)
    say("30 dist", f"DistDIA {n}²: spmv rel err vs spmv(DIA) {e_dia:.2e}, vs plain "
        f"{e_dia_ref:.2e}; 200 CG iterations x rel err vs phase 4 {e_cg:.2e}, ‖r‖ recursive "
        f"{float(info.residual_norm):.6e} true (f64) {r_true:.6e} of ‖b‖ {b_norm:.6e}; FEM "
        f"{nf} rows: spmv rel err (vs spmv(CSR), vs scipy) "
        + "; ".join(f"{k} {a:.2e}, {c:.2e}" for k, (a, c) in errs.items())
        + "; 200 CG iterations x rel err vs the CG over the CSR "
        + "; ".join(f"{k} {e:.2e}" for k, e in cg_errs.items())
        + f"; DistSlab halo {dists['DistSlab'].halo_windows} windows, DistCSRSubset hops "
        f"{dists['DistCSRSubset'].hop_m}; every SpMV and CG reran bitwise; launches {run}; "
        f"host seconds " + "; ".join(f"{k} {v:.3f}" for k, v in host.items()))

    # each shard product against its plain version, timed
    def x_ext(d, xv):
        """The vector the shard product of ``d`` reads at a world of one."""
        xl = full(d.padded_vector(xv, mesh))
        h = d.halo if isinstance(d, pdist.DistDIA) else (
            d.halo_windows * 128 if isinstance(d, pdist.DistSlab) else 0)
        return torch.nn.functional.pad(xl, (h, h)) if h else xl

    csr_t = torch_csr(csr)
    fem_t = torch_csr(fcsr)
    xe = x_ext(dA, x)
    cases = [("dist_dia_spmv", f"DistDIA {n}² Poisson", dA, xe,
              lambda: kd.dia_spmv(dA.shard, xe, pdist.LAUNCHES, "dist_dia_spmv"),
              lambda: kd.dia_spmv_ref(dA.shard, xe), lambda: torch.mv(csr_t, x),
              "dia_spmv_kernel", lambda: pdist.LAUNCHES["dist_dia_spmv"])]
    for name, label in (("dist_csr_spmv", "DistCSR"), ("dist_ell_spmv", "DistELL"),
                        ("dist_csr_subset_spmv", "DistCSRSubset")):
        d = dists[label]
        xg = x_ext(d, xf)
        cases.append((name, f"{label} FEM", d, xg,
                      (lambda d=d, xg=xg, name=name: krg.launch_spmv(
                          d.shard_plan(), xg, pdist.LAUNCHES, name)),
                      (lambda d=d, xg=xg: krg.spmv_walk(d.shard_plan(), xg)),
                      lambda: torch.mv(fem_t, xf), "rowgroup_spmv_kernel",
                      (lambda name=name: pdist.LAUNCHES[name])))
    dS = dists["DistSlab"]
    xs_ext = x_ext(dS, xf)
    cases.append(("dist_slab_spmv", "DistSlab FEM", dS, xs_ext,
                  lambda: tmv.planned_spmv(dS.shard, xs_ext, pdist.LAUNCHES, "dist_slab_spmv"),
                  lambda: ksl.slab_spmv_ref(dS.shard, xs_ext),
                  lambda: torch.mv(fem_t, xf), "rowgroup_spmv_kernel",
                  lambda: pdist.LAUNCHES["dist_slab_spmv"]))
    for name, label, d, xv, kernel_fn, plain_fn, lib_fn, key, counter in cases:
        compare(name, kernel_fn(), plain_fn(), TOL[torch.float32]["y"], f"{label} shard product")
        k_ms, p_ms, k_runs, p_runs = paired_ms(kernel_fn, plain_fn, 50, 5)
        xsh = d.padded_vector(x if isinstance(d, pdist.DistDIA) else xf, mesh)
        call_ms = cuda_ms(lambda d=d, xsh=xsh: d.matvec(xsh, mesh), 20)
        dev_ms = device_us(kernel_fn, 20, key, counter) / 1e3
        lib = library_ms(lib_fn, 20)
        if isinstance(d, pdist.DistDIA):
            n_d, r = len(d.offsets), d.rows_per_block
            n_bytes, by_what = (n_d * r + xv.numel() + r) * 4, "band"
            flops = 2 * n_d * r
            plan_desc = plan_picks(d.shard_plan())
        else:
            plan = d.shard_plan()
            n_bytes, by_what = shard_need(plan)
            flops = 2 * plan.nnz
            plan_desc = plan_line(label, plan, host[f"{label.split()[0]} plan"])
        b_ms, by = record(times, name, k_ms, p_ms, n_bytes, flops, lib)
        times[name].update(device_ms=dev_ms, call_ms=call_ms, bound_counts=by_what,
                           runs_ms=k_runs, plain_runs_ms=p_runs)
        say("30 times", f"{label} shard product: kernel {k_ms:.4f} ms runs "
            f"{[round(v, 4) for v in k_runs]}, device {dev_ms:.4f} ms ({b_ms / dev_ms:.1%} of "
            f"the bound), plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}, {by_what}); "
            f"torch.mv {lib:.4f} ms; the whole distributed SpMV call {call_ms:.4f} ms; "
            f"{plan_desc}")

    # launches per step of each path, and the DistDIA CG's rate beside phase 4's
    per = per_step(lambda: pdist.LAUNCHES, lambda j: dist_cg(dA, bs, j), 32)
    note_steps(times, "dist_dia_spmv", per["dist_dia_spmv"], f"CG iteration, DistDIA {n}²")
    bfs = dS.padded_vector(bf, mesh)
    per_s = per_step(lambda: pdist.LAUNCHES, lambda j: dist_cg(dS, bfs, j), 32)
    note_steps(times, "dist_slab_spmv", per_s["dist_slab_spmv"], "CG iteration, DistSlab FEM")
    for name, label in (("dist_csr_spmv", "DistCSR"), ("dist_ell_spmv", "DistELL"),
                        ("dist_csr_subset_spmv", "DistCSRSubset")):
        d = dists[label]
        xfs = d.padded_vector(xf, mesh)
        per_p = per_step(lambda: pdist.LAUNCHES,
                         lambda j, d=d, xfs=xfs: [d.matvec(xfs, mesh) for _ in range(j)], 1)
        note_steps(times, name, per_p[name], f"{label}.matvec product, FEM")
    plain_cg = (lambda: cg_iters_per_s(dia, b, 320))
    block_cg = (lambda: cg_iters_per_s(block_matvec(dA), bs.to_local(), 320))
    dist_rate = (lambda: cg_iters_per_s(lambda v: dA.matvec(v, mesh), bs, 320))
    rates = [plain_cg(), block_cg(), dist_rate(), dist_rate(), block_cg(), plain_cg()]
    say("30 times", f"launches per step: DistDIA CG {per}; DistSlab CG {per_s}; CG f32 {n}² "
        f"iters/s: DistDIA world 1 {(rates[2] + rates[3]) / 2:.1f} runs {rates[2:4]}; the "
        f"same CG over the rank's plain block, no DTensor {(rates[1] + rates[4]) / 2:.1f} runs "
        f"{[rates[1], rates[4]]}; phase 4's CG over the DIA {(rates[0] + rates[5]) / 2:.1f} "
        f"runs {[rates[0], rates[5]]}")
    torch.distributed.destroy_process_group()



def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the solvers through the kernels instead of the checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' products in f32
    torch.backends.cudnn.allow_tf32 = False

    # 1 ------------------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    say("1 device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
                    f"nvidia-smi:")
    print(smi.splitlines()[0], flush=True)
    if args.profile:
        profile_solvers(dev)
        return

    # 2 ------------------------------------------------------------------------
    say("2 build", "; ".join(f"{k} {v:.3f} s" for k, v in build_all().items()))

    # 3 ------------------------------------------------------------------------
    g = gen(dev)
    cases = [("odd n", 100_001, 100_001, (-300, -1, 0, 1, 300)),
             ("straddle 128", 50_000, 50_000, (-129, -127, 0, 127, 129)),
             ("one-row band", 1, 1, (0,)),
             ("halo 4096", 1 << 20, 1 << 20, (-4096, -1, 0, 1, 4096)),
             ("rectangular", 30_000, 40_001, (-5, 0, 3, 9000)),
             ("halo 4096 on 20,000", 20_000, 20_000, (-4096, -1, 0, 1, 4096)),
             ("band 10^4", 10_000, 10_000, (-100, -1, 0, 1, 100))]
    worst = {}
    chain_runs = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for label, nr, nc, offs in cases:
            A = averaging_dia(nr, nc, offs, dtype, g)
            x = torch.randn(nc, generator=g, dtype=dtype, device=dev)
            what = f"{label} {dtype}"
            errs = [compare("dia_spmv", kd.dia_spmv(A, x), kd.dia_spmv_ref(A, x),
                            tol["y"], f"dia_spmv {what}")]
            if nr == nc:
                y, d = kd.dia_spmv_dot(A, x)
                y_ref, d_ref = kd.dia_spmv_dot_ref(A, x)
                errs.append(compare("dia_spmv_dot", y, y_ref, tol["y"], f"dia_spmv_dot y {what}"))
                errs.append(compare("dia_spmv_dot", d, d_ref, tol["dot"], f"dia_spmv_dot dot {what}"))
                picked = kd.dia_chain_plan(A, dtype)
                plans = chain_plans(A, dtype)
                chain_runs[what] = f"{plan_label(picked)} picked; " + ", ".join(
                    plan_label(p) for p in plans)
                for k in (1, 2, 5, 1024):
                    want = kd.dia_spmv_chain_ref(A, x, k)
                    errs.append(compare(CHAIN_NAME[picked.kernel], kd.dia_spmv_chain(A, x, k),
                                        want, tol["y"], f"dia_spmv_chain k={k} {what}"))
                    for plan in plans:
                        errs.append(compare(CHAIN_NAME[plan.kernel],
                                            kd.dia_spmv_chain(A, x, k, plan), want, tol["y"],
                                            f"dia_spmv_chain k={k} {what} {plan_label(plan)}"))
            worst[what] = max(errs)
    torch.cuda.synchronize()
    limits = {str(dt).replace("torch.", ""): kd.cluster_limits(dev, dt)
              for dt in (torch.float32, torch.float64)}
    say("3 kernels", "all within tolerance; worst rel err per case: "
        + "; ".join(f"{w} {e:.2e}" for w, e in worst.items())
        + "; (shared bytes a CTA, largest cluster) " + str(limits)
        + "; chains run: " + "; ".join(f"{w}: {r}" for w, r in chain_runs.items()))

    # 4 ------------------------------------------------------------------------
    n = 2048
    kd.reset_launches()
    kk.reset_launches()
    csr, dia, (t_asm, t_csr, t_dia) = assemble_poisson(n, dev)
    m = n * n
    x = torch.randn(m, generator=g, device=dev)
    y_dia = tsm.spmv(dia, x)
    y_csr = tsm.spmv(csr, x)
    e_spmv = compare(None, y_dia, y_csr, 1e-5, "spmv DIA kernel vs CSR stream")
    y4 = tsm.spmv_chain(dia, x, 4)
    y4_csr = x
    for _ in range(4):
        y4_csr = tsm.spmv(csr, y4_csr)
    e_chain = compare(None, y4, y4_csr, 1e-5, "spmv_chain k=4 vs CSR stream")
    # the reference benchmark's banded_1e4 chain: a band that fits a cluster
    chain_csr = tsm.CSR.from_scipy(averaging_band(10_000, (-100, -1, 0, 1, 100), SEED),
                                  device=dev)
    chain_dia = chain_csr.to_dia()
    x_chain = torch.randn(10_000, generator=g, device=dev)
    y_chain = tsm.spmv_chain(chain_dia, x_chain, 1024)
    y_chain_csr = x_chain
    for _ in range(1024):
        y_chain_csr = tsm.spmv(chain_csr, y_chain_csr)
    e_chain_band = compare(None, y_chain, y_chain_csr, 1e-5, "spmv_chain 10^4 k=1024 vs CSR stream")
    b = tsm.spmv(csr, torch.randn(m, generator=g, device=dev))
    x_cg, info = solvers.cg(dia, b, tol=0.0, maxiter=200)
    torch.cuda.synchronize()
    launches = dict(kd.LAUNCHES)
    chains = dict(kd.CHAIN_KERNELS)
    launches.update({CHAIN_NAME[kern]: count for kern, count in chains.items()})
    launches.update(kk.LAUNCHES)                    # CG's step kernels
    for name, count in launches.items():
        check(count > 0, f"the main path launched {name} no time")
    with torch_body():
        x_plain, info_plain = solvers.cg(lambda v: kd.dia_spmv_ref(dia, v), b,
                                         tol=0.0, maxiter=200)
    check(int(info.iterations) == int(info_plain.iterations) == 200, "CG iterations")
    e_cg = compare(None, x_cg, x_plain, 1e-4, "CG x, kernels vs plain")
    r_true, b_norm = host_residual(csr, x_cg, b)
    r_rec = float(info.residual_norm)
    # the f32 recursive residual drifts from the true one by rounding in
    # the x and r updates; 5% bounds that drift at 200 iterations
    check(abs(r_true - r_rec) <= 0.05 * r_true, f"true residual {r_true} vs recursive {r_rec}")
    e_step = check_cg_step(g, dia)
    say("4 main path", f"2048² Poisson: {m} rows, {csr.n_non_zero_entries()} entries; "
        f"assemble {t_asm:.3f} s, to_csr {t_csr:.3f} s, to_dia {t_dia:.3f} s; "
        f"spmv rel err {e_spmv:.2e}; chain rel err {e_chain:.2e}; 10^4 band chain k=1024 "
        f"rel err {e_chain_band:.2e}; chains by kernel {chains}; CG 200 iters "
        f"x rel err kernels vs plain {e_cg:.2e}; one CG step, kernels vs plain, worst rel err "
        f"{e_step:.2e}; ‖r‖ recursive {r_rec:.6e} true (f64) "
        f"{r_true:.6e} of ‖b‖ {b_norm:.6e}; launches {launches}")

    # 5 ------------------------------------------------------------------------
    csr5, dia5, _ = assemble_poisson(512, dev)
    b5 = tsm.spmv(dia5, torch.randn(512 * 512, generator=g, device=dev))
    x5, info5 = solvers.cg(dia5, b5, tol=0.0, rtol=1e-5, maxiter=5000)
    check(bool(info5.converged), f"512² CG did not converge in {int(info5.iterations)}")
    r5, b5n = host_residual(csr5, x5, b5)
    check(r5 / b5n <= 1e-4, f"512² true relative residual {r5 / b5n:.3e} > 1e-4")
    say("5 converge", f"512² Poisson f32 to rtol 1e-5: {int(info5.iterations)} iterations, "
        f"true relative residual (f64 host) {r5 / b5n:.3e}")

    # 6 ------------------------------------------------------------------------
    check(torch.equal(tsm.spmv(dia, x), y_dia), "spmv (DIA) rerun differs")
    check(torch.equal(tsm.spmv(csr, x), y_csr), "spmv (CSR) rerun differs")
    ya, da = tsm.spmv_dot(dia, x)
    yb, db = tsm.spmv_dot(dia, x)
    check(torch.equal(ya, yb) and torch.equal(da, db), "spmv_dot rerun differs")
    x_cg2, info2 = solvers.cg(dia, b, tol=0.0, maxiter=200)
    check(torch.equal(x_cg2, x_cg) and torch.equal(info2.residual_norm, info.residual_norm),
          "CG rerun differs")
    say("6 determinism", "spmv (DIA, CSR), spmv_dot and 200-iteration CG rerun bitwise equal")

    # 7 ------------------------------------------------------------------------
    times = {}
    dia_spmv_times(dev, g, times, dia, csr)
    chain_times(dev, g, times)

    # CG's loop takes the fused SpMV + dot and the two step kernels; the
    # plain SpMV runs once before it, so the SpMV's step is a product of spmv
    cg_step_times(dev, g, times, dia, b)
    per = per_step(lambda: {**kd.LAUNCHES, **kk.LAUNCHES},
                   lambda j: solvers.cg(dia, b, tol=0.0, maxiter=j), 32, dia)
    for name in ("dia_spmv_dot", "cg_update", "cg_direction"):
        note_steps(times, name, per[name], "CG iteration, 2048² Poisson DIA")
    per_v = per_step(lambda: kd.LAUNCHES, lambda j: [tsm.spmv(dia, x) for _ in range(j)], 1)
    note_steps(times, "dia_spmv", per_v["dia_spmv"], "spmv(DIA, x) product, 2048² Poisson")
    per_c = per_step(chain_counts, lambda j: [tsm.spmv_chain(dia, x, 4) for _ in range(j)], 1)
    note_steps(times, "dia_spmv_chain", per_c["dia_spmv_chain"],
               "spmv_chain(DIA, x, 4) product, 2048² Poisson")
    check(per_c["dia_spmv_chain_cluster"] == 0, "the 2048² chain launched the cluster kernel")
    per_b = per_step(chain_counts, lambda j: [tsm.spmv_chain(chain_dia, x_chain, 1024)
                                              for _ in range(j)], 1)
    note_steps(times, "dia_spmv_chain_cluster", per_b["dia_spmv_chain_cluster"],
               "spmv_chain(DIA, x, 1024) product, 10^4-row band")
    check(per_b["dia_spmv_chain"] == 0, "the 10^4 band's chain launched the grid kernel")
    say("7 times", f"DIA launches per CG iteration {per}; per spmv {per_v}; per "
        f"spmv_chain(k=4) at 2048² {per_c}; per spmv_chain(k=1024) on the 10^4 band {per_b}")
    for label, A_, b_, iters in (("512²", dia5, b5, 640), ("2048²", dia, b, 320)):
        runs = [plain_cg_iters_per_s(A_, b_, iters), cg_iters_per_s(A_, b_, iters),
                cg_iters_per_s(A_, b_, iters), plain_cg_iters_per_s(A_, b_, iters)]
        say("7 times", f"CG f32 {label}: kernels {(runs[1] + runs[2]) / 2:.1f} iters/s "
            f"runs {runs[1:3]}; plain {(runs[0] + runs[3]) / 2:.1f} iters/s "
            f"runs {[runs[0], runs[3]]}")

    fem_phases(dev, g, times, launches)
    route_phases(dev, g, times, launches)
    spmm_phases(dev, g, times, launches)
    general_phases(dev, g, times, launches, csr)
    algebra_phases(dev, g)
    dist_phases(dev, g, times, launches, csr, dia, b, x_cg)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": MAX_ABS[name], **times[name]}
        for name, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
