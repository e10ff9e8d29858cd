"""Fixture tests of the port: goodpkg against its ref without the cuda marker;
badpkg only through the reference's package, which does not count."""
import pytest

from repro.kernels.badpkg import ops as bad_ops
from repro_torch.kernels.goodpkg import ops as good_ops
from repro_torch.kernels.goodpkg.ref import good_ref




def test_good_against_ref():
    assert good_ops.good(1) == good_ref(1)


def test_spare_without_ref():
    assert good_ops.spare(1) == 1


def test_bad_through_the_reference():
    assert bad_ops.bad(1) == bad_ops.bad_ref(1)
