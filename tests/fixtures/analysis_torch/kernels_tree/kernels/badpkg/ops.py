"""Fixture kernel package without a ref.py and without a test."""
import ctypes


def bad(x):
    return ctypes.CDLL("libbadpkg.so").bad_launch(x)
