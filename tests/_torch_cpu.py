"""The port's CPU tests ask for the CPU.

The port's entry points put what they build on the current CUDA card unless
the caller names a device, and raise where torch finds no card.  Each
``tests/test_torch_*.py`` imports ``port_on_cpu``, an autouse fixture that
points the port's default device at the CPU for every test of the file, so
calls that name no device build CPU tensors and the wrappers take their plain
versions.  ``real_default_device`` is the port's own policy, for the tests of
that policy."""

import pytest
import torch

from sparsemat_tpu_torch import types

real_default_device = types.default_device


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(types, "default_device", lambda: torch.device("cpu"))


class LazyModule:
    """A module imported at its first attribute read, inside a test, and the
    test skipped where it is missing: a file that reaches the JAX package
    through one collects where JAX is not installed (the card's machine)."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(pytest.importorskip(self._name), attr)


def plan_launches(counts: dict) -> dict:
    """The plan group's launch counts a test expects: ``counts``, and 0
    under every key it does not name."""
    from sparsemat_tpu_torch.kernels import _rowgroup

    return dict.fromkeys(_rowgroup.LAUNCHES, 0) | counts
