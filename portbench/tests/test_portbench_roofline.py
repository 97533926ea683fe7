"""The roofline counts on hand-worked shapes, and the reduction of a device
trace on made-up events."""

import pytest

import devtrace
import roofline


def test_poisson_spmv_bound_by_hand():
    # 20,963,328 values + 4,194,304 x + 4,194,304 y, 4 bytes each
    nnz, n = 20_963_328, 2048 * 2048
    assert roofline.product_bytes(nnz, n, n) == 117_407_744
    assert roofline.product_flops(nnz) == 41_926_656
    t, by = roofline.product_bound_s(nnz, n, n)
    assert by == "bytes"
    assert t == pytest.approx(117_407_744 / 3.35e12)
    assert t * 1e6 == pytest.approx(35.05, abs=0.01)


def test_fem_spmm_bound_by_hand():
    # 10,609,572 values + 217,920 × 128 of B + the same of Y
    nnz, n, m = 10_609_572, 217_920, 128
    n_bytes = (nnz + 2 * n * m) * 4
    assert roofline.product_bytes(nnz, n, n, m) == n_bytes == 265_588_368
    t, by = roofline.product_bound_s(nnz, n, n, m)
    assert by == "bytes" and t * 1e6 == pytest.approx(79.28, abs=0.01)
    # its operations alone take 2·nnz·m / 67 TFLOP/s
    assert roofline.product_flops(nnz, m) / roofline.F32_FLOP_PER_S * 1e6 == pytest.approx(
        40.54, abs=0.01)


def test_small_shapes_and_the_operation_bound():
    assert roofline.product_bytes(10, 4, 5, 3) == (10 + 9 * 3) * 4
    assert roofline.product_flops(10, 3) == 60
    # a dense 100 × 100 block against 1,000 columns: 20 MFLOP over 840 kB
    t, by = roofline.product_bound_s(10_000, 100, 100, 1000)
    assert roofline.product_bytes(10_000, 100, 100, 1000) == 840_000
    assert by == "operations" and t == pytest.approx(2e7 / 67e12)
    assert roofline.bound_s(3.35e12, 0) == (1.0, "bytes")


def test_share():
    assert roofline.share_pct(35e-6, 70e-6) == pytest.approx(50.0)
    assert roofline.share_pct(35e-6, 0) is None
    assert roofline.share_pct(35e-6, None) is None


def test_reduce_slice_busy_idle_and_gaps():
    events = [("k1", 10.0, 20.0),
              ("k2", 15.0, 25.0),       # overlaps k1
              ("k1", 40.0, 50.0),
              ("memcpy", 95.0, 120.0)]  # runs past the window
    host = [("aten::mul", 0.0, 12.0),
            ("aten::where", 26.0, 45.0), ("cudaLaunchKernel", 30.0, 34.0),
            ("aten::item", 60.0, 100.0)]
    r = devtrace.reduce_slice(events, (0.0, 100.0), host)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 25] + [40, 50] + [95, 100] = 30 µs
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["idle_pct"] == pytest.approx(70.0)
    assert r["count"] == 4
    assert r["device_s"] == pytest.approx((10 + 10 + 10 + 5) * 1e-6)
    assert r["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    gaps = dict((n, t) for n, t in r["idle_gaps"])
    # gap [0, 10] at 5: in aten::mul; [25, 40] at 32.5: in the launch inside
    # aten::where; [50, 95] at 72.5: in aten::item
    assert gaps == {"aten::mul": pytest.approx(10e-6),
                    "cudaLaunchKernel": pytest.approx(15e-6),
                    "aten::item": pytest.approx(45e-6)}


def test_reduce_slice_tail_gap_and_nothing_recorded():
    r = devtrace.reduce_slice([("k", 0.0, 10.0)], (0.0, 40.0), [("aten::add", 0.0, 12.0)])
    assert r["idle_gaps"] == [[devtrace.BETWEEN_OPS, pytest.approx(30e-6)]]
    empty = devtrace.reduce_slice([], (0.0, 40.0))
    assert empty["busy_s"] == 0 and empty["count"] == 0 and empty["idle_pct"] == 100.0
    assert empty["idle_gaps"] == [[devtrace.BETWEEN_OPS, pytest.approx(40e-6)]]


def test_innermost_host_op_by_time():
    ops = [("outer", 0.0, 100.0), ("a", 10.0, 20.0), ("b", 30.0, 60.0), ("c", 40.0, 50.0)]
    assert devtrace._innermost(ops, [5.0, 15.0, 25.0, 45.0, 55.0, 150.0]) == [
        "outer", "a", "outer", "c", "b", devtrace.BETWEEN_OPS]
