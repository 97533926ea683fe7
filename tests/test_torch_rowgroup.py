"""The row-group plan (``kernels/_rowgroup.py``) against the JAX package on
the same seeded inputs: the plan of every BSR, SlabELL, SlabPack, WELL,
StripELL and SlabStream holds exactly the entries its ``to_coo`` counts
(stored zeros kept, padding, dummy tiles and zero blocks gone, overflow
levels and class parts merged), compared on
values with the JAX package's ``to_csr`` and with scipy; the plan's walk
in the kernel's order equals ``bsr_spmm_xla``, ``slab_spmm_xla`` and the
interpret-mode ``slab_pack_spmm_pallas``; the grouping follows the
matrix; a term the plan masks off is skipped, so a non-finite B gives what
a CSR SpMM gives.  The CUDA kernel itself is held to the plain versions by
the ``cuda`` tests of test_torch_bsr_spmm.py, test_torch_slab.py and
test_torch_spmm.py.

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order) and 1e-12 in f64; entries are compared exactly.  f32 operands are
passed explicitly, because ``tests/conftest.py`` turns on JAX's x64 mode.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import matgen
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import slab as ksl
from sparsemat_tpu_torch.kernels import spmm as ksp


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    import jax.numpy as jnp
    from sparsemat_tpu.kernels import spmm as jks

    return jsm, jnp, jks


def scattered(n_rows, n_cols, density, seed, empty_rows=None, zeros=()):
    """Random entries; rows ``empty_rows`` cleared and the stored entries
    at ``zeros`` set to the value zero."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    dense[rng.random((n_rows, n_cols)) >= density] = 0
    if empty_rows is not None:
        dense[empty_rows] = 0
    m = sp.csr_matrix(dense)
    m.data[list(zeros)] = 0.0
    return m


def mixed_degree(n, seed):
    """Interleaved light and heavy rows (tests/test_gell_pack.py): the
    SlabPack spills into an overflow pack."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), np.where(np.arange(n) % 7, 3, 60))
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def fem(n_nodes=1500):
    """A dof-blocked FEM band (``matgen.fem_block_band``, 3 dof a node)."""
    return matgen.fem_block_band(n_nodes=n_nodes, bandwidth=600, seed=1).tocsr()


MATRICES = {
    # empty rows 40–119, a stored zero, a ragged last block of every shape
    "holes_300x520": lambda: scattered(300, 520, 0.03, 11, empty_rows=slice(40, 120),
                                       zeros=(0, 7)),
    # columns end mid-window, so slab windows reach past n_cols
    "rect_300x200": lambda: scattered(300, 200, 0.05, 4),
    "mixed_700": lambda: mixed_degree(700, 0),      # the SlabPack has an overflow
    "fem_900": lambda: fem(300),
    "empty": lambda: sp.csr_matrix((77, 130), dtype=np.float32),
}
#: (label, freeze) of the formats whose SpMV or SpMM runs a row-group kernel
FREEZES = {
    "bsr_8x128": lambda c: tsm.BSR.from_csr(c),
    "bsr_64x256": lambda c: tsm.BSR.from_csr(c, br=64, bc=256),
    "bsr_device_512x128": lambda c: tsm.BSR.from_csr_device(c, br=512, bc=128),
    "slab_128": lambda c: c.to_slab(rb=128),
    "slab_256": lambda c: c.to_slab(rb=256),
    "pack": lambda c: c.to_slab_pack(),
    "pack_rb128_c3": lambda c: tsm.SlabPack.from_csr(c, rb=128, n_classes=3),
    "well": lambda c: c.to_well(),
    "strip": lambda c: c.to_strip(),
    "strip_pack1": lambda c: c.to_strip(lidx_pack=1),
    "slab_stream_128": lambda c: c.to_slab_stream(rb=128),
    "slab_stream_256": lambda c: c.to_slab_stream(rb=256),
}


def plan_entries(plan):
    """The plan's (row, col, val) triplets, read back group by group."""
    G = plan.group
    ptr = plan.grp_ptr.numpy()
    grp = np.repeat(np.arange(plan.n_groups), np.diff(ptr))
    cols = plan.cols.numpy().astype(np.int64)
    mask = plan.mask.numpy().astype(np.int64)
    vals = plan.vals.numpy()
    out = [(grp * G + i, cols, vals[i]) for i in range(G)]
    on = [(mask >> i) & 1 == 1 for i in range(G)]
    r, c, v = (np.concatenate([o[k][b] for o, b in zip(out, on)]) for k in range(3))
    return sp.csr_matrix((v, (r, c)), shape=plan.shape)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_csr(jmat):
    jc = jmat.to_csr()
    indptr = np.asarray(jc.indptr)
    nnz = int(indptr[-1])
    return sp.csr_matrix((np.asarray(jc.data)[:nnz], np.asarray(jc.indices)[:nnz], indptr),
                         shape=tuple(jc.shape))


def jax_freeze(jsm, m, label):
    jc = jsm.CSR.from_scipy(m)
    return {"bsr_8x128": lambda: jsm.BSR.from_csr(jc),
            "bsr_64x256": lambda: jsm.BSR.from_csr(jc, br=64, bc=256),
            "bsr_device_512x128": lambda: jsm.BSR.from_csr_device(jc, br=512, bc=128),
            "slab_128": lambda: jc.to_slab(rb=128),
            "slab_256": lambda: jc.to_slab(rb=256),
            "pack": lambda: jc.to_slab_pack(),
            "pack_rb128_c3": lambda: jsm.SlabPack.from_csr(jc, rb=128, n_classes=3),
            "well": lambda: jc.to_well(),
            "strip": lambda: jc.to_strip(),
            "strip_pack1": lambda: jc.to_strip(lidx_pack=1),
            "slab_stream_128": lambda: jc.to_slab_stream(rb=128),
            "slab_stream_256": lambda: jc.to_slab_stream(rb=256)}[label]()


# -- the plan's entries ----------------------------------------------------------------

@pytest.mark.parametrize("label", FREEZES)
@pytest.mark.parametrize("name", MATRICES)
def test_plan_holds_exactly_the_entries(name, label):
    jsm, _, _ = jax_ref()
    m = MATRICES[name]()
    m.sort_indices()
    try:
        mat = FREEZES[label](tsm.CSR.from_scipy(m))
    except ValueError as e:             # a StripELL wider than one tile: both refuse it
        if "span" not in str(e):
            raise
        with pytest.raises(ValueError, match="span"):
            jax_freeze(jsm, m, label)
        pytest.skip(f"{name}: both packages' StripELL freeze refuses its column span")
    plan = rg.plan_of(mat)
    got = plan_entries(plan)
    coo = mat.to_coo()
    stored = coo.rows.long() < m.shape[0]
    want = sp.csr_matrix((coo.vals[stored].numpy(), (coo.rows[stored].numpy(),
                                                     coo.cols[stored].numpy())), shape=m.shape)
    assert plan.nnz == got.nnz == want.nnz == mat.n_non_zero_entries()
    for ref in (want, jax_csr(jax_freeze(jsm, m, label))):
        ref = ref.tocsr()
        ref.sort_indices()
        got.sort_indices()
        np.testing.assert_array_equal(got.indptr, ref.indptr)      # positions, stored zeros
        np.testing.assert_array_equal(got.indices, ref.indices)    # included
        np.testing.assert_array_equal(got.data, ref.data)
    if label != "bsr_device_512x128":     # the device freeze keeps no stored zero
        assert got.nnz == m.nnz and abs(got - m).max() == 0
    assert 1 <= plan.group <= rg.MAX_GROUP and plan.n_groups == -(-m.shape[0] // plan.group)
    assert plan.grp_ptr[-1] == plan.n_union
    if isinstance(mat, tsm.SlabPack) and mat.overflow is not None:
        assert rg.plan_of(mat) is plan                  # built once, parts and overflow merged


def test_plan_drops_entries_outside_the_matrix_and_keeps_duplicates():
    rows = torch.tensor([0, 0, 0, 3, 5, -1, 2, 1])
    cols = torch.tensor([1, 1, 4, 0, 0, 0, 9, 2])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    plan = rg.build(rows, cols, vals, (4, 5))          # row 5, row -1 and col 9 lie outside
    got = plan_entries(plan)
    assert plan.nnz == 5
    # the two entries at (0, 1) are two terms (their sum here)
    np.testing.assert_array_equal(got.toarray(), [[0, 3, 0, 0, 3], [0, 0, 8, 0, 0],
                                                  [0, 0, 0, 0, 0], [4, 0, 0, 0, 0]])
    Y = rg.walk(plan, torch.tensor([[0.0], [1.0], [0.0], [0.0], [0.0]]))
    assert Y[0, 0] == 3.0                              # 1·1 + 2·1


def test_slab_pack_of_a_bsr_freeze_has_the_same_plan():
    m = fem(400)
    c = tsm.CSR.from_scipy(m)
    a, b = rg.plan_of(tsm.BSR.from_csr_device(c, br=512)), rg.plan_of(c.to_slab_pack())
    assert a.group == b.group
    for f in ("grp_ptr", "cols", "mask", "vals"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- the grouping --------------------------------------------------------------------------

def test_dof_rows_of_a_node_share_one_group():
    plan = rg.plan_of(tsm.CSR.from_scipy(fem(1500).astype(np.float32)).to_slab_pack())
    assert plan.group == 3
    assert plan.padding < 0.08                         # only the node's diagonal differs


def test_scattered_rows_take_groups_of_one():
    m = scattered(2000, 3000, 0.002, 2)
    plan = rg.plan_of(tsm.CSR.from_scipy(m).to_slab())
    assert plan.group == 1 and plan.padding == 0.0 and plan.n_union == m.nnz


# -- the walk in the kernel's order against the JAX package ---------------------------------

@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-5), (np.float64, 1e-12)], ids=["f32", "f64"])
@pytest.mark.parametrize("m_rhs", [1, 5, 17])
@pytest.mark.parametrize("name", ["holes_300x520", "fem_900", "mixed_700"])
def test_walk_matches_bsr_and_slab_xla_oracles(name, m_rhs, dt, tol):
    jsm, jnp, jks = jax_ref()
    m = MATRICES[name]().astype(dt)
    B = np.random.default_rng(m_rhs).standard_normal((m.shape[1], m_rhs)).astype(dt)
    tc, jc = tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)
    Bt, Bj = torch.from_numpy(B), jnp.asarray(B)
    cases = [(rg.plan_of(tsm.BSR.from_csr(tc, br=16, bc=256)),
              jks.bsr_spmm_xla(jsm.BSR.from_csr(jc, br=16, bc=256), Bj)),
             (rg.plan_of(tc.to_slab(rb=128)), jks.slab_spmm_xla(jc.to_slab(rb=128), Bj))]
    for plan, want in cases:
        got = rg.walk(plan, Bt)
        assert got.dtype == Bt.dtype and got.shape == (m.shape[0], m_rhs)
        assert rel_err(got, want) < tol
        assert rel_err(got, m.astype(np.float64) @ B.astype(np.float64)) < tol


@pytest.mark.parametrize("name", ["mixed_700", "holes_300x520"])
def test_walk_matches_the_slab_pack_pallas_composition(name):
    jsm, jnp, jks = jax_ref()
    m = MATRICES[name]()
    jp = jsm.SlabPack.from_csr(jsm.CSR.from_scipy(m), rb=128, n_classes=3)
    tp = tsm.SlabPack.from_csr(tsm.CSR.from_scipy(m), rb=128, n_classes=3)
    B = np.random.default_rng(2).standard_normal((m.shape[1], 3)).astype(np.float32)
    want = jks.slab_pack_spmm_pallas(jp, jnp.asarray(B), interpret=True)
    got = rg.walk(rg.plan_of(tp), torch.from_numpy(B))
    assert rel_err(got, want) < 1e-5
    assert rel_err(got, ksl.slab_pack_spmm_ref(tp, torch.from_numpy(B))) < 1e-5


def test_walk_of_bf16_values_is_computed_in_f32():
    m = MATRICES["fem_900"]()
    mat = tsm.CSR.from_scipy(m).astype(torch.bfloat16).to_slab_pack()
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((m.shape[1], 4))).float()
    plan = rg.plan_of(mat)
    assert plan.vals.dtype == torch.float32
    got = rg.walk(plan, B.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert rel_err(got, ksl.slab_pack_spmm_ref(mat, B.to(torch.bfloat16))) < 1e-5


def test_walk_skips_what_the_plan_masks_off():
    """Where B holds inf: a BSR block's unstored zero and a slab's padding
    slot give no NaN (a CSR SpMM's answer), a stored zero does (0 · inf)."""
    m = scattered(64, 256, 0.05, 5)
    m.data[0] = 0.0                                         # a stored zero
    r0, c0 = 0, int(m.indices[0])
    free = next(j for j in range(256) if m[:, j].nnz == 0)  # a column no entry reads
    B = np.ones((256, 3), np.float32)
    B[c0, 0] = np.inf
    B[free, 1] = np.nan
    want = m @ B                      # scipy: NaN only where a stored entry meets inf/NaN
    assert np.isnan(want[r0, 0]) and not np.isnan(want[:, 1]).any()
    for mat in (tsm.BSR.from_csr(tsm.CSR.from_scipy(m)), tsm.CSR.from_scipy(m).to_slab()):
        got = rg.walk(rg.plan_of(mat), torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    dense = ksp.bsr_spmm_ref(tsm.BSR.from_csr(tsm.CSR.from_scipy(m)), torch.from_numpy(B))
    assert torch.isnan(dense[:, 1]).any()    # the plain version's dense blocks: 0 · NaN


def test_plan_of_a_bsr_without_tiles_and_of_no_rows():
    none = tsm.BSR(blocks=torch.zeros((0, 8, 128)), block_rows=torch.zeros(0, dtype=torch.int32),
                   block_cols=torch.zeros(0, dtype=torch.int32), occ=None, shape=(64, 256))
    plan = rg.plan_of(none)
    assert plan.nnz == plan.n_union == 0 and plan.group == 1 and plan.n_groups == 64
    assert torch.equal(rg.walk(plan, torch.ones(256, 2)), torch.zeros(64, 2))
    plan = rg.build(torch.zeros(0), torch.zeros(0), torch.zeros(0), (0, 5))
    assert plan.n_groups == 0 and rg.walk(plan, torch.ones(5, 2)).shape == (0, 2)


def test_plan_is_cached_per_matrix():
    m = MATRICES["holes_300x520"]()
    b = tsm.BSR.from_csr(tsm.CSR.from_scipy(m))
    assert rg.plan_of(b) is rg.plan_of(b)
    b64 = b.astype(torch.float64)                      # a new matrix: a plan of its own
    assert "_rowgroup_plan" not in b64.__dict__
    assert rg.plan_of(b64).vals.dtype == torch.float64
    assert rg.plan_of(b).vals_as(torch.float64) is rg.plan_of(b).vals_as(torch.float64)
