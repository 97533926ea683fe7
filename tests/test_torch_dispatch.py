"""Which path ``ops.spmv`` and ``ops.spmm`` take for each planned format
under each ``method``, on the CPU: the conversion the dispatch records in
``ops.conversions``, and an answer bitwise that of the plain version the
table names (the format's own ``*_ref``, or the path its conversion leads
to).

The planned formats are the seven whose products run on a card as one
launch over the matrix's row-group plan: StripELL, WELL, SlabELL, SlabPack,
SlabStream, RouteStream and BSR (its SpMM only).  A ``method`` that names a
format freezes the matrix to it unless the matrix's own format comes first
in the dispatch's order; the tables below spell that order out case by
case."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.formats.dia import dia_spmm, dia_spmv
from sparsemat_tpu_torch.kernels import dia as kd
from sparsemat_tpu_torch.kernels import route as kr
from sparsemat_tpu_torch.kernels import slab as ksl
from sparsemat_tpu_torch.kernels import spmm as ksp
from sparsemat_tpu_torch.kernels import strip as ks
from sparsemat_tpu_torch.kernels import well as kw
from sparsemat_tpu_torch.ops import matvec as tmv
from sparsemat_tpu_torch.utils import profiling

PLANNED = ("strip", "well", "slab", "slab_pack", "slab_stream", "route", "bsr")
FREEZE = {"strip": lambda c: c.to_strip(), "well": lambda c: c.to_well(),
          "slab": lambda c: c.to_slab(rb=128), "slab_pack": lambda c: c.to_slab_pack(rb=128),
          "slab_stream": lambda c: c.to_slab_stream(rb=128), "route": lambda c: c.to_route(),
          "bsr": lambda c: tsm.BSR.from_csr(c)}


def _coo_spmv(m, x):
    coo = m.to_coo().sort()
    return tmv._stream_spmv(coo.indptr(), coo.cols, coo.vals, x)


#: the plain SpMV that answers on a matrix of each format (BSR's: through COO)
SPMV_PLAIN = {"strip": ks.strip_spmv_ref, "well": kw.well_spmv_ref,
              "slab": ksl.slab_spmv_ref, "slab_pack": ksl.slab_pack_spmv_ref,
              "slab_stream": ksl.slab_stream_spmv_ref, "route": kr.route_spmv_ref,
              "bsr": _coo_spmv, "dia": kd.dia_spmv_ref, "dia_xla": dia_spmv,
              "gell": tmv._gell_spmv, "ell": tmv._ell_spmv}
#: the plain SpMM; StripELL, WELL, SlabStream and RouteStream go through CSR,
#: whose branch takes the ELL gather on this matrix
SPMM_PLAIN = {"bsr": ksp.bsr_spmm_ref, "slab": ksl.slab_spmm_ref,
              "slab_pack": ksl.slab_pack_spmm_ref, "dia": dia_spmm,
              "gell": tmv._gell_spmm, "ell": tmv._ell_spmm}
THROUGH_CSR = ("strip", "well", "slab_stream", "route")

#: spmv: method → the formats that keep themselves; every other planned
#: format is frozen to the method's format (``pallas``: WELL, ``dia_xla``: DIA)
SPMV_KEEPS = {
    None: set(PLANNED),
    "pallas": {"well"},
    "dia": set(),
    "dia_xla": set(),
    "strip": {"strip"},
    "route": {"strip", "route"},
    "slab_stream": {"strip", "route", "slab_stream"},
    "slab_pack": {"strip", "route", "slab_stream", "slab_pack"},
    "slab": {"strip", "route", "slab_stream", "slab_pack", "slab"},
    "well": {"strip", "route", "slab_stream", "slab_pack", "slab", "well"},
    "gell": {"strip", "route", "slab_stream", "slab_pack", "slab", "well"},
    "ell": {"strip", "route", "slab_stream", "slab_pack", "slab", "well"},
}
SPMV_TARGET = {"pallas": "well", "dia_xla": "dia"}

#: spmm: the same (``pallas``: BSR)
SPMM_KEEPS = {
    None: set(PLANNED),
    "pallas": {"bsr"},
    "bsr": {"bsr"},
    "dia": {"bsr"},
    "slab_pack": {"bsr", "slab_pack"},
    "slab": {"bsr", "slab_pack", "slab"},
    "gell": {"bsr", "slab_pack", "slab"},
    "ell": {"bsr", "slab_pack", "slab"},
}
SPMM_TARGET = {"pallas": "bsr"}


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch's CPU ops on one thread: each case is hundreds of small ops,
    which threads spinning in parallel test workers slow many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_tables_name_every_method():
    assert tuple(SPMV_KEEPS) == tmv._SPMV_METHODS
    assert tuple(SPMM_KEEPS) == tmv._SPMM_METHODS


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(20)
    n = 300
    m = sp.random(n, n, 0.03, random_state=rng, format="coo", dtype=np.float64)
    keep = np.abs(m.row - m.col) <= 40
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=(n, n)).tocsr()
    m = (m + sp.eye(n, format="csr")).astype(np.float32)
    csr = tsm.CSR.from_scipy(m, device="cpu")
    mats = {f: FREEZE[f](csr) for f in PLANNED}
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    return mats, x, B


def _traced(fn):
    profiling.reset_trace()
    with profiling.tracing():
        out = fn()
    conv = profiling.trace_record()["counters"]["ops.conversions"]
    return out, {k: n for k, n in conv.items() if n}


@pytest.mark.parametrize("method", tmv._SPMV_METHODS)
def test_spmv_takes_the_pinned_path(operands, method):
    mats, x, _ = operands
    for fmt in PLANNED:
        mat = mats[fmt]
        y, conv = _traced(lambda: tsm.spmv(mat, x, method=method))
        if fmt in SPMV_KEEPS[method]:
            want_conv, plain, on = ({"coo": 1} if fmt == "bsr" else {}), SPMV_PLAIN[fmt], mat
        else:
            target = SPMV_TARGET.get(method, method)
            want_conv = {target: 1}
            on = getattr(mat, f"to_{target}")()
            plain = SPMV_PLAIN[method if method == "dia_xla" else target]
        assert conv == want_conv, (fmt, method)
        assert torch.equal(y, plain(on, x)), (fmt, method)


@pytest.mark.parametrize("method", tmv._SPMM_METHODS)
def test_spmm_takes_the_pinned_path(operands, method):
    mats, _, B = operands
    for fmt in PLANNED:
        mat = mats[fmt]
        Y, conv = _traced(lambda: tsm.spmm(mat, B, method=method))
        if fmt in SPMM_KEEPS[method] and fmt in THROUGH_CSR:
            want_conv = {"csr": 1, "ell": 1}
            want = tmv._ell_spmm(mat.to_csr().to_ell(), B)
        elif fmt in SPMM_KEEPS[method]:
            want_conv, want = {}, SPMM_PLAIN[fmt](mat, B)
        else:
            target = SPMM_TARGET.get(method, method)
            want_conv = {target: 1}
            on = (tsm.BSR.from_csr(mat.to_csr()) if target == "bsr"
                  else getattr(mat, f"to_{target}")())
            want = SPMM_PLAIN[target](on, B)
        assert conv == want_conv, (fmt, method)
        assert torch.equal(Y, want), (fmt, method)
