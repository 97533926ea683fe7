"""The frozen operator generators reproduce the operators that
``chip_smoke.py`` and ``matgen`` build at seed 0: entry counts and a
checksum of the triplets, held as numbers here and against the originals."""

import hashlib
import os

import numpy as np

import harness

#: (stored entries, checksum) of each configuration's triplets at seed 0
FROZEN = {"poisson2d_4m": (20_963_328, "4e6935656e77076e"),
          "fem_pwtk": (10_609_572, "5b59e5d1b8d1a731")}


def checksum(*arrays):
    h = hashlib.sha256()
    for a, dt in zip(arrays, (np.int64, np.int64, np.float32)):
        h.update(np.ascontiguousarray(a, dt).tobytes())
    return h.hexdigest()[:16]


def test_poisson_matches_chip_smoke():
    import chip_smoke

    cell = harness.Cell("poisson2d_4m.cg")
    rows, cols, vals, shape = cell.triplets(0)
    assert shape == (2048 * 2048,) * 2
    assert (rows.size, checksum(rows, cols, vals)) == FROZEN["poisson2d_4m"]
    assert checksum(*chip_smoke.poisson_triplets(2048)) == FROZEN["poisson2d_4m"][1]


def test_fem_matches_chip_smoke_and_matgen():
    import chip_smoke
    from sparsemat_tpu_torch import matgen

    cell = harness.Cell("fem_pwtk.spmm128")
    rows, cols, vals, shape = cell.triplets(0)
    assert shape == (217_920, 217_920)
    assert (rows.size, checksum(rows, cols, vals)) == FROZEN["fem_pwtk"]
    r, c, v, n, _ = chip_smoke.fem_triplets()
    assert checksum(r, c, v) == FROZEN["fem_pwtk"][1]
    ours = cell.generator.fem_block_band(seed=0)
    theirs = matgen.fem_block_band(seed=0)
    assert checksum(ours.indptr, ours.indices, ours.data) == checksum(
        theirs.indptr, theirs.indices, theirs.data)


def test_fem_is_drawn_from_the_seed_and_spd_by_dominance():
    cell = harness.Cell("fem_pwtk.spmm128", overrides={"n_nodes": 400, "bandwidth": 30})
    a = cell.triplets(2**31 + 11)
    b = cell.triplets(2**31 + 11)
    c = cell.triplets(5)
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert checksum(*a[:3]) != checksum(*c[:3])
    rows, cols, vals, (n, _) = a
    off = rows != cols
    rowsum = np.bincount(rows[off], weights=np.abs(vals[off]).astype(np.float64), minlength=n)
    diag = np.zeros(n)
    diag[rows[~off]] = vals[~off]
    assert np.all(diag - rowsum >= 1.0 - 1e-5)


def test_every_configuration_names_a_generator_file():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(harness.HERE, "configs", cfg["generator"] + ".py"))
        assert cfg["reduced"] == c["reduced"]
