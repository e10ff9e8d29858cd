"""Fixture plain versions of goodpkg's kernels."""


def good_ref(x):
    return x


def spare_ref(x):
    return x
