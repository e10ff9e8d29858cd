"""Fixture kernel package: wrappers over two CUDA entries."""
import ctypes


def _lib():
    return ctypes.CDLL("libgoodpkg.so")


def good(x):
    return _lib().good_launch(x)


def spare(x):
    return _lib().spare_launch(x)
