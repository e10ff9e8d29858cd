"""Known-bad fixture: torch's global generator in a transcript path (the
`serve/` scope).  Line numbers are pinned by tests/test_torch_analysis.py
— edit both together."""
import torch


def draw(n, gen: torch.Generator):
    a = torch.rand(n)                               # line 8: DT002
    b = torch.randn(n, generator=gen)               # seeded: exempt
    c = torch.randint(0, 5, (n,))                   # line 10: DT002
    torch.manual_seed(0)                            # line 11: DT002
    d = torch.empty(n).uniform_(0, 1)               # line 12: DT002
    e = torch.empty(n).normal_(generator=gen)       # seeded: exempt
    f = torch.randperm(n)                           # line 14: DT002
    g = torch.rand_like(a)                          # line 15: DT002
    h = gen.manual_seed(1)                          # its own generator
    return a, b, c, d, e, f, g, h
