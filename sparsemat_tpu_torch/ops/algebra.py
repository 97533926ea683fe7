"""Matrix algebra (counterpart of ``sparsemat_tpu/ops/algebra.py``): ``add``
/ ``sub``, ``transpose``, SpGEMM, the bilinear form ``inner_prod`` and the
structure predicates.

Every result has the JAX package's layout: a canonical COO (row-major,
column-sorted, tail padding ``row == n_rows``) turned back into the left
operand's class where that is CSR or ELL.  ``add`` and ``transpose`` keep
the operands' slots, padding included; SpGEMM's one-shot expansion keeps
nse_A × K_B slots and its ESC path stores exactly the coordinates the
product reaches, zeros included (``prune(keep_zeros=False)`` drops them).

Sums are sorted-segment reductions (``torch.segment_reduce``) behind a
stable sort, never atomics, so reruns on the card are bitwise equal.
The ops read sizes on the host and so run eagerly: under ``torch.compile``
they break the graph and take the same path as outside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.base import dedup_sorted_coo, sort_coo
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.ell import ELL
from ..types import accum_dtype, compute_index_dtype
from .matvec import spmv


class DimensionError(ValueError):
    """Operand shapes that do not fit the operation."""


def _same_format_as(template, coo: COO):
    """A canonical COO result in the input's format class (CSR, ELL, or COO
    for every other class)."""
    if isinstance(template, CSR):
        return coo.to_csr()
    if isinstance(template, ELL):
        return coo.to_csr().to_ell()
    return coo


def add(a, b):
    """A + B: the union of the patterns, values summed.  The result's shape
    is the larger of each dimension, its slots nse_A + nse_B (coordinates
    that coincide leave tail padding), its index dtype A's, and its values
    the promoted dtype of the two."""
    ca, cb = a.to_coo(), b.to_coo()
    shape = (max(ca.shape[0], cb.shape[0]), max(ca.shape[1], cb.shape[1]))

    def retag(c):   # each operand's padding to the merged shape's pad row
        r = c.rows.long()
        valid = r < c.shape[0]
        return (torch.where(valid, r, shape[0]), torch.where(valid, c.cols.long(), 0),
                torch.where(valid, c.vals, 0))

    ra, cca, va = retag(ca)
    rb, ccb, vb = retag(cb)
    dt = torch.promote_types(va.dtype, vb.dtype)
    r, c, v = sort_coo(torch.cat([ra, rb]), torch.cat([cca, ccb]),
                       torch.cat([va.to(dt), vb.to(dt)]), shape)
    r, c, v, _ = dedup_sorted_coo(r, c, v, shape)
    idt = ca.index_dtype
    return _same_format_as(a, COO(rows=r.to(idt), cols=c.to(idt), vals=v, shape=shape,
                                  canonical=True))


def sub(a, b):
    """A − B."""
    return add(a, b.scale(-1))


def transpose(a):
    """Aᵀ: the coordinates swapped and sorted once (no duplicates are
    summed; the slots and their padding are A's)."""
    coo = a.to_coo()
    n_rows, n_cols = coo.shape
    r = coo.rows.long()
    valid = r < n_rows
    shape = (n_cols, n_rows)
    r, c, v = sort_coo(torch.where(valid, coo.cols.long(), n_cols), torch.where(valid, r, 0),
                       torch.where(valid, coo.vals, 0), shape)
    idt = coo.index_dtype
    return _same_format_as(a, COO(rows=r.to(idt), cols=c.to(idt), vals=v, shape=shape,
                                  canonical=True))


#: cap on the materialised B-ELL operand of the one-shot SpGEMM (the JAX
#: package's): past it, or past ``max_fanout_slots`` candidates, the ESC
#: path runs
_SPGEMM_ELL_BUDGET = 1 << 28  # 256 MB
#: candidate products per ESC part (one expand, sort and compress each); a
#: part of 2^27 peaks near 8 GB of device memory
_SPGEMM_PART_SLOTS = 1 << 27


def spgemm(a, b, *, n_cols_per_row_b: int | None = None, max_fanout_slots: int = 1 << 25):
    """C = A @ B for two sparse operands, in A's format class (CSR, ELL, or
    COO for the rest).

    Where A's slots times K_B (B's longest row, or ``n_cols_per_row_b``)
    stay within ``max_fanout_slots`` and B's ELL within 256 MB, B is frozen
    to ELL and every slot of A fans out against its row in one
    (nse_A × K_B) expansion, then one sort and one dedup follow (the
    result keeps all nse_A × K_B slots, padding included).  Otherwise the
    ESC path (``_spgemm_device_esc``) runs: exact expansion over B's CSR,
    row-aligned parts, one sort and segment sum each.  The same thresholds
    as the JAX package's, so both take the same path and give the same
    nse.  Every coordinate the product reaches is stored, zeros included.
    The inner dimensions must agree (``DimensionError``)."""
    if a.shape[1] != b.shape[0]:
        raise DimensionError(f"spgemm: inner dimensions differ — {a.shape} @ {b.shape}")
    ca = a.to_coo()
    shape = (a.shape[0], b.shape[1])
    adt = accum_dtype(torch.promote_types(ca.vals.dtype, b.dtype))
    bcsr = b.to_csr()
    kb = n_cols_per_row_b if n_cols_per_row_b is not None else max(bcsr.max_row_nnz(), 1)
    ell_bytes = bcsr.shape[0] * kb * (4 + adt.itemsize)   # int32 col + accum value
    if ca.nse * kb > max_fanout_slots or ell_bytes > _SPGEMM_ELL_BUDGET:
        acsr = a if isinstance(a, CSR) else a.to_csr()
        return _same_format_as(a, _spgemm_device_esc(ca, bcsr, shape, adt, acsr=acsr))
    bell = bcsr.to_ell(n_cols_per_row=n_cols_per_row_b)
    return _same_format_as(a, _spgemm_oneshot(ca, bell, shape, bell.n_cols_per_row, adt))


def _spgemm_oneshot(ca, bell, shape, kb, adt):
    """Every slot (i, k, a_ik) of A against the kb slots of B's ELL row k:
    nse_A × kb candidates (invalid ones as padding), one sort, one dedup."""
    r = ca.rows.long()
    a_valid = r < ca.shape[0]
    a_rows = torch.where(a_valid, r, shape[0])
    a_k = torch.where(a_valid, ca.cols.long(), 0)
    b_cols = bell.cols[a_k]                                    # (nse_A, kb)
    b_vals = bell.vals[a_k]
    b_nnz = bell.row_nnz[a_k].long()
    slot_valid = ((torch.arange(kb, device=r.device)[None, :] < b_nnz[:, None])
                  & a_valid[:, None])
    rows = torch.where(slot_valid, a_rows[:, None], shape[0]).reshape(-1)
    cols = torch.where(slot_valid, b_cols.long(), 0).reshape(-1)
    vals = torch.where(slot_valid, ca.vals.to(adt)[:, None] * b_vals.to(adt), 0).reshape(-1)
    r, c, v = sort_coo(rows, cols, vals, shape)
    r, c, v, _ = dedup_sorted_coo(r, c, v, shape)
    idt = compute_index_dtype(ca.index_dtype)
    return COO(rows=r.to(idt), cols=c.to(idt), vals=v, shape=shape, canonical=True)


@dataclasses.dataclass(frozen=True)
class EscPlan:
    """Where the ESC path cuts the product: A's entry e reaches
    ``fan[e]`` candidates (the length of B's row at its column), numbered
    from ``fan_end[e] - fan[e]``; row i's candidates start at
    ``cand_ptr[i]``; part p covers rows ``[row_cuts[p], row_cuts[p + 1])``."""

    fan: torch.Tensor        # (nnz_A,) int64, on the operands' device
    fan_end: torch.Tensor    # (nnz_A,) int64, inclusive running sum of fan
    cand_ptr: np.ndarray     # (n_rows + 1,) int64, on the host
    row_cuts: list

    @property
    def n_candidates(self) -> int:
        return int(self.cand_ptr[-1])

    @property
    def n_parts(self) -> int:
        return len(self.row_cuts) - 1


def esc_plan(acsr, bcsr, part_slots: int = _SPGEMM_PART_SLOTS) -> EscPlan:
    """The ESC path's parts: each candidate counted on the device, the
    (n_rows + 1) row offsets of the candidates read back, and rows cut
    greedily into parts of at most ``part_slots`` candidates (a row with
    more takes a part of its own)."""
    n_rows = acsr.shape[0]
    nnz = acsr.n_non_zero_entries()
    indptr_b = bcsr.indptr.long()
    deg_b = indptr_b[1:] - indptr_b[:-1]
    fan = deg_b[acsr.indices[:nnz].long()]
    fan_end = torch.cumsum(fan, 0)
    ends = torch.cat([fan_end.new_zeros(1), fan_end])
    cand_ptr = ends[acsr.indptr.long()].cpu().numpy()
    cuts = [0]
    while cuts[-1] < n_rows:
        lo = cuts[-1]
        hi = int(np.searchsorted(cand_ptr, cand_ptr[lo] + part_slots, side="right")) - 1
        cuts.append(min(max(hi, lo + 1), n_rows))
    return EscPlan(fan=fan, fan_end=fan_end, cand_ptr=cand_ptr, row_cuts=cuts)


def _esc_part(acsr, bcsr, plan: EscPlan, r0: int, r1: int, adt):
    """Rows [r0, r1) of C: expand their candidates, sort them stably by
    (row, col), and sum each run of equal coordinates in expansion order.
    Returns the part's (rows, cols, vals), canonical, no padding."""
    ip = acsr.host("indptr")
    e0, e1 = int(ip[r0]), int(ip[r1])
    c0, c1 = int(plan.cand_ptr[r0]), int(plan.cand_ptr[r1])
    dev = acsr.data.device
    n_cols = bcsr.shape[1]
    fan = plan.fan[e0:e1]
    # B's position of each entry's first candidate, less the candidate's
    # number within the part: candidate t of entry e reads B at base[e] + t
    base = bcsr.indptr.long()[acsr.indices[e0:e1].long()] - (plan.fan_end[e0:e1] - fan - c0)
    ent = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), fan, output_size=c1 - c0)
    pos = base[ent].add_(torch.arange(c1 - c0, device=dev))
    key = (acsr.row_ids[e0:e1].long() - r0)[ent].mul_(n_cols).add_(bcsr.indices[pos].long())
    val = acsr.data[e0:e1].to(adt)[ent] * bcsr.data[pos].to(adt)
    del ent, pos
    key, order = torch.sort(key, stable=True)
    val = val[order]
    del order
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    del key
    sums = torch.segment_reduce(val, "sum", lengths=counts, unsafe=True)
    return torch.div(uniq, n_cols, rounding_mode="floor").add_(r0), uniq % n_cols, sums


def _spgemm_device_esc(ca, bcsr, shape, adt, *, part_slots: int = _SPGEMM_PART_SLOTS,
                       acsr=None):
    """Expand–sort–compress SpGEMM.  A's entries are read from its CSR
    (``acsr``, built from ``ca`` when not given), each fanned out over its
    B row with ``repeat_interleave``; rows are cut into parts of about
    ``part_slots`` candidates (``esc_plan``), and each part is one stable
    sort of the key row·n_cols + col and one segment sum of each run of
    equal keys.  Parts cover disjoint row ranges in order, so they
    concatenate into a canonical COO with no padding, whatever the part
    size.  A product with no candidates is one padding slot.  The result's
    index dtype is ``ca``'s widened to int32 at least."""
    n_rows = shape[0]
    idt = compute_index_dtype(ca.index_dtype)
    if acsr is None:
        acsr = ca.to_csr()
    plan = esc_plan(acsr, bcsr, part_slots)
    if plan.n_candidates == 0:
        dev = ca.vals.device
        return COO(rows=torch.full((1,), n_rows, dtype=idt, device=dev),
                   cols=torch.zeros(1, dtype=idt, device=dev),
                   vals=torch.zeros(1, dtype=adt, device=dev), shape=shape, canonical=True)
    out = [[], [], []]
    for r0, r1 in zip(plan.row_cuts[:-1], plan.row_cuts[1:]):
        if plan.cand_ptr[r1] == plan.cand_ptr[r0]:
            continue
        r, c, v = _esc_part(acsr, bcsr, plan, r0, r1, adt)
        out[0].append(r.to(idt))
        out[1].append(c.to(idt))
        out[2].append(v)
    rows, cols, vals = (torch.cat(t) if len(t) > 1 else t[0] for t in out)
    return COO(rows=rows, cols=cols, vals=vals, shape=shape, canonical=True)


def inner_prod(mat, l, r):
    """lᵀ A r: one ``spmv`` and a dot, summed in the accumulation dtype of
    l and A r (bf16/f16 in f32)."""
    y = spmv(mat, r)
    l = torch.as_tensor(l, device=y.device)
    adt = accum_dtype(torch.promote_types(l.dtype, y.dtype))
    return torch.dot(l.to(adt), y.to(adt))


def is_symmetric(a, *, rtol=0.0, atol=0.0) -> torch.Tensor:
    """A == Aᵀ (exactly by default) as a 0-d bool tensor on A's device: the
    canonical streams of A and Aᵀ compared slot by slot, or their dense
    forms where the two streams differ in length."""
    if a.shape[0] != a.shape[1]:
        return torch.tensor(False, device=a.device)
    ca = a.to_coo().sort()
    cat = transpose(a).to_coo().sort()
    if ca.nse != cat.nse:
        d = ca.todense()
        return torch.all(torch.abs(d - d.T) <= atol + rtol * torch.abs(d))
    same_struct = torch.all((ca.rows == cat.rows) & (ca.cols == cat.cols))
    close = torch.all(torch.abs(ca.vals - cat.vals) <= atol + rtol * torch.abs(ca.vals))
    return same_struct & close


def extract_row(mat, i):
    """Row i as a ``SparseVec``."""
    return mat.to_csr().get_row(i)


def is_sorted_row(mat, i) -> torch.Tensor:
    """Row i's columns strictly ascending, as a 0-d bool tensor."""
    csr = mat.to_csr()
    k = torch.arange(csr.nse, device=csr.device)
    ip = csr.indptr.long()
    interior = (k >= ip[i]) & (k + 1 < ip[i + 1])
    cols = csr.indices.long()
    return torch.all(torch.where(interior, cols < torch.roll(cols, -1), True))


def is_sorted(mat) -> torch.Tensor:
    """Every row's columns strictly ascending, as a 0-d bool tensor.  The
    port's freezes give sorted rows; this checks arrays built elsewhere."""
    csr = mat.to_csr()
    nse = csr.nse
    if nse <= 1:
        return torch.tensor(True, device=csr.device)
    cols = csr.indices.long()
    rows = csr.row_ids.long()
    k = torch.arange(nse, device=csr.device)
    same_row = (rows == torch.roll(rows, -1)) & (k + 1 < nse) & (k + 1 < csr.indptr[-1])
    return torch.all(torch.where(same_row, cols < torch.roll(cols, -1), True))
