"""Known-bad fixture: host syncs and tensor branches on hot paths.  The
hot roots are `step`, `host_route` and `make_fns.decode`.  Line numbers
are pinned by tests/test_torch_analysis.py — edit both together."""
import numpy as np
import torch


def step(x: torch.Tensor, n: int):
    if x.sum() > 0:                                 # line 9: TH001
        x = x * 2
    if x.shape[0] > n and x is not None:            # host values: exempt
        x = x[:n]
    v = x.max().item()                              # line 13: TH002
    w = float(x[0])                                 # line 14: TH002
    host = torch.zeros(4)                           # a host tensor
    h = host.tolist()                               # host: exempt
    idx = torch.nonzero(x)                          # line 17: TH002
    y = torch.from_numpy(np.ones(3)).to(x.device)   # line 18: TH002
    z = torch.from_numpy(np.ones(3)).pin_memory().to(x.device,
                                                     non_blocking=True)
    torch.cuda.current_stream().synchronize()       # line 21: TH002
    flag = (x > 0).any() or n > 1                   # line 22: TH001
    a = np.asarray(x)                               # line 23: TH002
    return helper(x), v, w, h, idx, y, z, flag, a


def helper(t: torch.Tensor) -> torch.Tensor:
    return t.cpu()                                  # line 28: TH002


def host_route(x: torch.Tensor, device: torch.device):
    if device.type != "cuda":
        return x.numpy()                            # off the card: exempt
    return x.to("cpu")                              # line 34: TH002


def cold(x: torch.Tensor):
    return x.item()                                 # unreachable: exempt


class Net(torch.nn.Module):
    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.mean() > 0:                            # line 43: TH001
            return t
        return -t


def make_fns(model):
    def decode(tokens: torch.Tensor):
        return model(tokens).argmax(-1).tolist()    # line 50: TH002

    def unused(t: torch.Tensor):
        return t.item()                             # not called: exempt

    return decode, unused
