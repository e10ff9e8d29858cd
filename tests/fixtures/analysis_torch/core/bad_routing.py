"""Known-bad fixture: device and env routing frozen at import or at the
first call, and data-dependent sizes under a CUDA-graph capture or a
torch.compile'd call.  Line numbers are pinned by
tests/test_torch_analysis.py — edit both together."""
import functools
import os

import torch

ON_CARD = torch.cuda.is_available()                 # line 10: TH003
N_CARDS = torch.cuda.device_count()                 # line 11: TH003
FLAG = os.environ.get("FIXTURE_FLAG", "0")          # line 12: TH003


@functools.lru_cache(maxsize=None)
def card_name():                                    # line 16: TH004
    return torch.cuda.get_device_name(0)


@functools.cache
def route():                                        # line 21: TH004
    return os.environ.get("FIXTURE_ROUTE", "np")


def per_call():
    return torch.cuda.is_available()                # resolved per call


def capture_decode(step, tokens):
    n = tokens.shape[0]
    buf = torch.zeros(n, 8, device="cuda")          # line 31: TH005
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step(buf)
    return g


def capture_bucketed(step, tokens):
    bucket = 1 << (tokens.shape[0] - 1).bit_length()
    buf = torch.zeros(bucket, 8, device="cuda")     # pow2 ladder: exempt
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step(buf)
    return g


@torch.compile
def compiled_step(x):
    return x * 2


def call_compiled(tokens):
    n = len(tokens)
    x = torch.empty(n, device="cuda")               # line 54: TH005
    return compiled_step(x)
