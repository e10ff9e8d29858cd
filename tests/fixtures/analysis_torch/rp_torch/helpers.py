"""Fixture helpers: line numbers are pinned by
tests/test_torch_analysis.py — edit both together."""
import torch


def sample(n):
    g = torch.Generator().manual_seed(0)
    a = torch.rand(n, generator=g)                  # seeded: exempt
    b = torch.randn(n)                              # line 9: RP003
    torch.manual_seed(n)                            # line 10: RP003
    return a, b


def offline(n):
    return torch.rand(n)                            # unreachable: exempt
